"""The card's energy counter, read through NVML (``libnvidia-ml``, part of
the GPU's system software) with ctypes: millijoules since it loaded,
the power limit in force, and the SM clock and the reasons it is held
down. ``Meter(index)`` is ``None``-valued where
NVML or the counter is missing; the metric that needs it is then left
out of the result."""
from __future__ import annotations

import ctypes


class Meter:
    def __init__(self, device_index=0):
        self._lib = self._handle = None
        try:
            import torch

            lib = ctypes.CDLL("libnvidia-ml.so.1")
            if lib.nvmlInit_v2() != 0:
                return
            handle = ctypes.c_void_p()
            uuid = "GPU-" + str(torch.cuda.get_device_properties(
                device_index).uuid)
            if lib.nvmlDeviceGetHandleByUUID(uuid.encode(),
                                             ctypes.byref(handle)) != 0:
                return
            self._lib, self._handle = lib, handle
            if self.joules() is None:
                self._lib = None
        except (OSError, AttributeError, RuntimeError):
            self._lib = None

    def joules(self):
        """The counter in joules, or None."""
        if self._lib is None:
            return None
        mj = ctypes.c_ulonglong()
        if self._lib.nvmlDeviceGetTotalEnergyConsumption(
                self._handle, ctypes.byref(mj)) != 0:
            return None
        return mj.value * 1e-3

    def power_limit_w(self):
        if self._lib is None:
            return None
        mw = ctypes.c_uint()
        if self._lib.nvmlDeviceGetEnforcedPowerLimit(
                self._handle, ctypes.byref(mw)) != 0:
            return None
        return mw.value * 1e-3

    def sm_clock_mhz(self):
        """The SM clock now, in MHz, or None."""
        if self._lib is None:
            return None
        mhz = ctypes.c_uint()
        if self._lib.nvmlDeviceGetClockInfo(self._handle, 1,    # NVML_CLOCK_SM
                                            ctypes.byref(mhz)) != 0:
            return None
        return mhz.value

    def clock_reasons(self):
        """NVML's bit mask of the reasons the clocks are held below their
        maximum now (1 idle, 4 power cap, 8 hardware slowdown, 32 and 64
        thermal), or None."""
        if self._lib is None:
            return None
        mask = ctypes.c_ulonglong()
        for name in ("nvmlDeviceGetCurrentClocksEventReasons",
                     "nvmlDeviceGetCurrentClocksThrottleReasons"):
            fn = getattr(self._lib, name, None)
            if fn is not None:
                return (mask.value if fn(self._handle, ctypes.byref(mask))
                        == 0 else None)
        return None
