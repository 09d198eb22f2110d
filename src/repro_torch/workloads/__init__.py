"""Scenario workloads: generated IIoT traffic for the routing plane.

  * :mod:`repro_torch.workloads.generators` — composable, RNG-keyed
    traffic primitives (arrival processes, popularity distributions,
    per-cell skew, length distributions), numpy draws identical to the
    JAX package's, packed into tensors by ``to_request_batch``.
  * :mod:`repro_torch.workloads.scenario` — the declarative
    ``ScenarioSpec``, the registry of the 9 named scenarios, ``FaultSpec``
    and ``compile_scenario``, which turns a spec into a
    ``core.batch_router.RequestBatch`` on a named device.

The windowed simulator (``repro.workloads.simulate``) is not ported yet.
"""
from repro_torch.workloads.scenario import (  # noqa: F401
    FaultSpec,
    ScenarioSpec,
    compile_scenario,
    get_scenario,
    list_scenarios,
    register,
)
