"""The port's cell-major layout, mesh and request buckets vs the JAX
package's (``repro_torch.core.batch_router``'s layout helpers,
``distributed.sharding.make_mesh``, ``core.mesh_router.cells_mesh`` and
``_bucket_requests``, ``launch.serve.validate_mesh_flag``).

The same fleets (the reference's ``EdgeServer`` lists, drawn with numpy)
and the same streams go through both packages: the layouts, the
rejections (matched by message), the permuted and block-local fleets
and every bucket array must be equal. The mesh checks run on CPU
meshes: D entries of the CPU device stand in for the reference's forced
host devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_router as rbr
from repro.core import mesh_router as rmr
from repro.core.catalog import build_catalog as ref_build_catalog
from repro.core.router import EdgeServer
from repro.launch import serve as rserve
from repro_torch.core import batch_router as tbr
from repro_torch.core import mesh_router as tmr
from repro_torch.core.catalog import build_catalog
from repro_torch.core.router import CLOUD_CELL
from repro_torch.distributed import sharding
from repro_torch.launch import serve as tserve

ARCHS = tserve.EDGE_ARCHS
CATALOG, REF_CATALOG = build_catalog(ARCHS), ref_build_catalog(ARCHS)


def _edge(i, cell, rng):
    return EdgeServer(
        name=f"c{cell}-es{i}", flops_per_s=float(rng.uniform(5e13, 2e14)),
        cache_slots=2, uplink_bps=float(rng.uniform(5e7, 2e8)),
        backhaul_bps=float(rng.uniform(5e8, 2e9)),
        resident=list(rng.choice(len(ARCHS), size=2, replace=False)),
        cell=cell, drain_rate=float(rng.uniform(0.0, 2000.0)))


def _fleet(rng, n_cells, per_cell, cloud=True):
    fleet = [_edge(i, c, rng) for c in range(n_cells)
             for i in range(per_cell)]
    if cloud:
        fleet.append(rserve.make_cloud_server(REF_CATALOG, drain_rate=50.0))
    return fleet


def _both(fleet):
    """(reference params, state), (port params, state) of one fleet."""
    return (rbr.fleet_from_servers(fleet, REF_CATALOG),
            tbr.fleet_from_servers(fleet, CATALOG, device="cpu"))


def _same_tree(got, ref):
    assert type(got)._fields == type(ref)._fields
    for k, g, r in zip(type(got)._fields, got, ref):
        assert (g is None) == (r is None), k
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(r)), k


def test_layout_of_canonical_and_untopologied_fleets():
    rng = np.random.default_rng(0)
    for fleet in (_fleet(rng, 3, 4), _fleet(rng, 2, 3, cloud=False)):
        (rp, _), (tp, _) = _both(fleet)
        got = tbr.cell_layout(tp)
        assert got == tuple(rbr.cell_layout(rp))
        assert isinstance(got, tbr.CellLayout)
        assert got.num_edge == got.num_cells * got.per_cell
        assert got.num_servers == len(fleet)
    (rp, _), (tp, _) = _both(_fleet(rng, 1, 5, cloud=False))
    for p, mod in ((rp, rbr), (tp, tbr)):
        assert tuple(mod.cell_layout(p._replace(cell=None))) == (1, 5, 0)


@pytest.mark.parametrize("case,msg", [
    ("interleaved", "contiguous ascending"),
    ("unequal", "equal-sized"),
    ("mid-cloud", "CLOUD_CELL servers must trail"),
    ("gap", "exactly 0..C-1"),
    ("cloud-only", "no edge servers"),
])
def test_cell_layout_rejects_what_the_reference_rejects(case, msg):
    rng = np.random.default_rng(1)
    cloud = rserve.make_cloud_server(REF_CATALOG)
    fleet = {
        "interleaved": [_edge(0, 0, rng), _edge(0, 1, rng), _edge(1, 0, rng),
                        _edge(1, 1, rng)],
        "unequal": [_edge(0, 0, rng), _edge(1, 0, rng), _edge(0, 1, rng)],
        "mid-cloud": [_edge(0, 0, rng), cloud, _edge(0, 1, rng)],
        "gap": [_edge(0, 0, rng), _edge(0, 2, rng)],
        "cloud-only": [cloud],
    }[case]
    (rp, _), (tp, _) = _both(fleet)
    with pytest.raises(ValueError, match=msg) as ref_err:
        rbr.cell_layout(rp)
    with pytest.raises(ValueError, match=msg) as got_err:
        tbr.cell_layout(tp)
    assert str(got_err.value) == str(ref_err.value)


def test_cell_major_order_and_permute_fleet_round_trip():
    rng = np.random.default_rng(2)
    fleet = _fleet(rng, 3, 2)
    shuffled = [fleet[i] for i in rng.permutation(len(fleet))]
    (rp, rs), (tp, ts) = _both(shuffled)
    order = tbr.cell_major_order(tp.cell)
    assert np.array_equal(order, rbr.cell_major_order(np.asarray(rp.cell)))
    assert np.array_equal(order, tbr.cell_major_order(tp.cell.numpy()))
    spill = torch.ones((3, 3), dtype=torch.bool)
    tp = tp._replace(spill=spill)
    p2, s2 = tbr.permute_fleet(tp, ts, order)
    rp2, rs2 = rbr.permute_fleet(rp._replace(spill=jnp.asarray(spill)), rs,
                                 order)
    _same_tree(p2, rp2)
    _same_tree(s2, rs2)
    assert p2.spill is spill  # per-cell, rides through
    assert tuple(tbr.cell_layout(p2)) == (3, 2, 1)
    p3, s3 = tbr.permute_fleet(p2, s2, np.argsort(order))
    _same_tree(p3, tp)
    _same_tree(s3, ts)


@pytest.mark.parametrize("block", [0, 2])
def test_local_block_params_match_reference(block):
    rng = np.random.default_rng(3)
    (rp, _), (tp, _) = _both(_fleet(rng, 3, 2))
    spill = np.eye(3, dtype=bool)
    layout = tbr.cell_layout(tp)
    got = tbr.local_block_params(tp._replace(spill=torch.as_tensor(spill)),
                                 layout, block)
    ref = rbr.local_block_params(rp._replace(spill=jnp.asarray(spill)),
                                 rbr.cell_layout(rp), block)
    _same_tree(got, ref)
    assert got.spill is None
    assert got.cell.tolist() == [0, 0, CLOUD_CELL]
    _same_tree(tmr.local_template_params(tp),
               rmr.local_template_params(rp))


def test_make_mesh_refuses_to_undersubscribe():
    cpu = torch.device("cpu")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=f"require {n + 1} device.*platform exposes {n}"):
        sharding.make_mesh((n + 1,), ("x",))
    with pytest.raises(ValueError, match="devices argument supplies 1"):
        sharding.make_mesh((2,), ("x",), devices=[cpu])
    with pytest.raises(ValueError, match="one device type"):
        sharding.make_mesh((2,), ("x",), devices=[cpu, "cuda:0"])
    mesh = sharding.make_mesh((2, 3), ("a", "b"), devices=[cpu] * 6)
    assert mesh.shape == {"a": 2, "b": 3}
    assert mesh.devices.shape == (2, 3) and mesh.axis_names == ("a", "b")


def test_cells_mesh_on_the_cpu_and_without_cards():
    for d in (1, 3, 8):
        mesh = tmr.cells_mesh(d, "cpu")
        assert mesh.axis_names == ("cells",) and mesh.shape == {"cells": d}
        assert all(x == torch.device("cpu") for x in mesh.devices.flat)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"but {n} are available"):
        tmr.cells_mesh(n + 1, "cuda")
    with pytest.raises(ValueError, match="at least one device"):
        tmr.cells_mesh(0, "cpu")


def _stream(rng, n, n_cells, *, orphans=True):
    cell = rng.integers(0, n_cells, n)
    if orphans:  # out-of-range cells see only the cloud
        cell[rng.random(n) < 0.15] = rng.choice([-1, -5, n_cells, 9])
    return dict(
        model=rng.integers(0, len(ARCHS), n).astype(np.int32),
        prompt_bits=rng.uniform(1e5, 1e6, n).astype(np.float32),
        gen_tokens=rng.integers(1, 64, n).astype(np.float32),
        cell=cell.astype(np.int32),
        arrival_s=np.cumsum(rng.exponential(2e-3, n)).astype(np.float32),
        deadline_s=rng.choice([0.05, 5.0, np.inf], n).astype(np.float32),
        eta=rng.choice([0.0, 0.25, 0.5, 1.0], n).astype(np.float32),
        beta=rng.random(n) < 0.5,
        local_flops_per_s=rng.uniform(5e11, 5e12, n).astype(np.float32))


@pytest.mark.parametrize("keep_cells", [False, True])
@pytest.mark.parametrize("c_pad,has_time,columns", [
    (3, True, "all"), (6, True, "all"), (4, False, "bare")])
def test_bucket_requests_match_reference(c_pad, has_time, columns,
                                         keep_cells):
    rng = np.random.default_rng(4 + c_pad)
    cols = _stream(rng, 70, 3)
    if columns == "bare":
        cols = {k: cols[k] for k in ("model", "prompt_bits", "gen_tokens",
                                     "cell", "arrival_s")}
    layout = (3, 2, 1)
    ref = rmr._bucket_requests(
        rbr.RequestBatch(**{k: jnp.asarray(v) for k, v in cols.items()}),
        rbr.CellLayout(*layout), c_pad, 0.125, has_time, keep_cells)
    got = tmr._bucket_requests(
        tbr.RequestBatch(**{k: torch.as_tensor(v) for k, v in cols.items()}),
        tbr.CellLayout(*layout), c_pad, 0.125, has_time, keep_cells)
    assert len(got) == len(ref) == 10
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None), i
        if g is not None:
            assert g.dtype == r.dtype and np.array_equal(g, r), i
    gpos = got[-1]
    assert sorted(gpos[gpos >= 0].tolist()) == list(range(70))
    assert got[0].shape[0] == c_pad and got[0].shape[1] % tmr._BUCKET_ROUND \
        == 0


def test_validate_mesh_flag():
    tserve.validate_mesh_flag(None, "cpu")
    tserve.validate_mesh_flag(1, "cpu")
    for bad in (0, 2):
        with pytest.raises(SystemExit, match=f"--mesh {bad} needs"):
            tserve.validate_mesh_flag(bad, "cpu")
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"only {n} are available"):
        tserve.validate_mesh_flag(n + 1, "cuda")
    with pytest.raises(SystemExit, match="--mesh 2 needs"):  # before set-up
        tserve.serve(num_requests=8, execute=False, device="cpu", mesh=2)
