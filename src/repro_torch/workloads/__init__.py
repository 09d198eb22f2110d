"""Scenario workloads: generated IIoT traffic for the routing plane.

  * :mod:`repro_torch.workloads.generators` — composable, RNG-keyed
    traffic primitives (arrival processes, popularity distributions,
    per-cell skew, length distributions), numpy draws identical to the
    JAX package's, packed into tensors by ``to_request_batch``.
  * :mod:`repro_torch.workloads.scenario` — the declarative
    ``ScenarioSpec``, the registry of the 9 named scenarios, ``FaultSpec``
    and ``compile_scenario``, which turns a spec into a
    ``core.batch_router.RequestBatch`` on a named device.
  * :mod:`repro_torch.workloads.simulate` — the long-horizon episode
    runner: windows a stream into ``route_batch`` calls, carries the
    ``FleetState`` across windows and aggregates per-window series. Its
    mesh-sharded windows (``mesh=``/``num_devices=``) come with ROADMAP
    Queue 1 item 10.
"""
from repro_torch.workloads.scenario import (  # noqa: F401
    FaultSpec,
    ScenarioSpec,
    compile_scenario,
    get_scenario,
    list_scenarios,
    register,
)
from repro_torch.workloads.simulate import SimResult, simulate  # noqa: F401
