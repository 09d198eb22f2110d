"""The host side of the route_score kernel, held without a card.

The wrapper (``kernels/route_score.py``) plans the grid, decides which
columns the kernel reads as they are and whether eta/beta fold into the
kernel; the kernel packs residency and spill into bit masks. Each is
held here against what it replaces: the plan covers every output once,
the packed masks gate exactly as the plain version's gathers, and the
kernel's eta/beta folding rounds as ``costs.apply_eta_beta`` does. The
kernel itself is held against the plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import costs
from repro_torch.kernels import ref
from repro_torch.kernels import route_score as rs

DTYPES = [torch.float32, torch.float64, torch.bfloat16]
SHAPES = [(5, 3), (257, 17), (130, 65), (300, 1), (70, 257), (256, 64),
          (256, 65), (65536, 64), (600_000, 64), (3, 5000)]


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.float64, 2),
                                       (torch.bfloat16, 8)])
def test_plan_stores_16_byte_vectors(dtype, vec):
    """On a panel, where the plan stages (the router's chunks take one
    score a thread)."""
    p = rs.plan(65536, 64, dtype, 132)
    assert not p.direct and p.vec == vec and p.vec * dtype.itemsize == 16


def _walk(p, b, n):
    """The rows and the columns the threads of a staged plan write, walked
    as the kernel walks them: per-row counts (B,) over (strip, chunk of
    blockDim.x = tx * ty rows, thread row) and per-column counts (N,) over
    (tile, thread column)."""
    rows = np.zeros(b, np.int64)
    chunk = p.tx * p.ty
    for strip in range(p.strips):
        r0, r1 = strip * p.strip_rows, min((strip + 1) * p.strip_rows, b)
        for c0 in range(r0, r1, chunk):
            nrows = min(chunk, r1 - c0)
            for gy in range(p.ty):
                rows[c0 + np.arange(gy, nrows, p.ty)] += 1
    cols = np.zeros(n, np.int64)
    for tile in range(p.col_tiles):
        for gx in range(p.tx):
            n0 = tile * p.tx * p.vec + gx * p.vec
            cols[n0:min(n0 + p.vec, n)] += 1
    return rows, cols


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n", SHAPES)
def test_plan_covers_every_output_once(b, n, dtype, sms):
    """Staged: each block is one (column tile, row strip); a thread owns
    vec columns and walks its strip's row groups: every (row, column) pair
    is written exactly once (rows and columns are walked independently).
    Direct: thread i of the grid writes output i, and the grid's last
    block holds the last output."""
    p = rs.staged_plan(b, n, dtype, sms)
    rows, cols = _walk(p, b, n)
    assert (rows == 1).all() and (cols == 1).all()
    d = rs.direct_plan(b, n)
    assert d.direct and d.threads == rs.THREADS
    assert (d.blocks - 1) * d.threads < b * n <= d.blocks * d.threads
    assert rs.plan(b, n, dtype, sms) in (p, d)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n", SHAPES)
def test_plan_fits_the_launch_and_balances_the_strips(b, n, dtype):
    sms = 132
    p = rs.staged_plan(b, n, dtype, sms)
    assert 1 <= p.tx <= rs.MAX_TX and p.threads <= rs.THREADS
    assert p.blocks < 2**31 and p.blocks == p.col_tiles * p.strips
    assert p.blocks <= max(p.col_tiles, sms * rs.BLOCKS_PER_SM)
    # no empty strip, and all strips but the last of equal length
    assert (p.strips - 1) * p.strip_rows < b <= p.strips * p.strip_rows
    # fewer rows than a block's ty each only when there are few rows
    assert p.strip_rows >= p.ty or p.strips == -(-b // p.strip_rows)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_sends_the_main_path_direct_and_panels_through_staging(dtype):
    """The chunked router's (256, 64) calls on a 132-SM card would give a
    staged block a strip of at most one row a thread: they take one score
    a thread, 64 blocks. The (65536, 64) panels give each staged block a
    strip of many rows, two blocks an SM."""
    small = rs.plan(256, 64, dtype, 132)
    assert small.direct and small.blocks == 256 * 64 // rs.THREADS
    staged = rs.staged_plan(256, 64, dtype, 132)
    assert staged.strip_rows <= staged.ty
    big = rs.plan(65536, 64, dtype, 132)
    assert not big.direct and big.strip_rows > big.ty
    assert big.blocks == 132 * rs.BLOCKS_PER_SM


def test_plan_lifts_the_row_limit_of_the_two_dimensional_grid():
    """The first kernel put rows on grid.y (65535 blocks of 8 rows) and
    raised above 524,280 rows; the plan gives each block a strip."""
    for b in (524_280, 524_281, 600_000, 10_000_000):
        p = rs.plan(b, 64, torch.float32, 132)
        assert not p.direct and p.blocks <= 132 * rs.BLOCKS_PER_SM
        assert p.strips * p.strip_rows >= b


# -------------------------------------------------- types the kernel reads
@pytest.mark.parametrize("out,cols,expect", [
    (torch.float32, [torch.float32] * 4, torch.float32),
    (torch.float64, [torch.float64] * 4, torch.float64),
    (torch.bfloat16, [torch.bfloat16] * 4, torch.bfloat16),
    (torch.bfloat16, [torch.bfloat16, torch.float32], torch.float32),
    (torch.float32, [torch.float32, torch.float64], torch.float32),
    (torch.float32, [torch.bfloat16, torch.float32], torch.float32),
])
def test_in_dtype_follows_the_plain_versions_compute_type(out, cols, expect):
    assert rs.in_dtype(out, cols) == expect


@pytest.mark.parametrize("cols,eta,folds", [
    (torch.float32, torch.float32, True),
    (torch.float64, torch.float64, True),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.float64, False),   # the product is float64
    (torch.float64, torch.float32, False),
    (torch.bfloat16, torch.float32, False),  # the product is float32
])
def test_eta_folds_in_the_kernel_only_in_the_columns_type(cols, eta, folds):
    b = 4
    prompt, work = torch.ones(b, dtype=cols), torch.ones(b, dtype=cols)
    read = rs.in_dtype(cols, [prompt.dtype, work.dtype])
    assert rs.folds_eta(torch.ones(b, dtype=eta), prompt, work, read,
                        b) is folds
    assert rs.folds_eta(0.5, prompt, work, read, b) is False
    assert rs.folds_eta(torch.ones(1, dtype=cols), prompt, work, read,
                        b) is False


def test_beta_folds_in_the_kernel_only_as_a_bool_column():
    assert rs.folds_beta(torch.ones(4, dtype=torch.bool), 4)
    assert not rs.folds_beta(torch.ones(4, dtype=torch.uint8), 4)
    assert not rs.folds_beta(torch.ones(4), 4)
    assert not rs.folds_beta(torch.ones(5, dtype=torch.bool), 4)
    assert not rs.folds_beta(True, 4)


# ------------------------------------------------- eta/beta folding rules
def _columns(seed, b, n, k, dtype, cells=0):
    rng = np.random.default_rng(seed)

    def f(x):
        return torch.as_tensor(x, dtype=torch.float64).to(dtype)

    args = dict(
        prompt_bits=f(rng.uniform(1e5, 1e6, b)),
        size_bits=f(rng.uniform(1e9, 1e10, b)),
        flops_tok=f(rng.uniform(1e9, 1e10, b)),
        work=f(rng.uniform(1e10, 1e12, b)),
        uplink_bps=f(rng.uniform(5e7, 2e8, n)),
        backhaul_bps=f(rng.uniform(5e8, 2e9, n)),
        flops_per_s=f(rng.uniform(5e13, 2e14, n)),
        queue_tokens=f(rng.uniform(0, 500, n)),
        resident=torch.as_tensor(rng.random((n, k)) < 0.5),
        model=torch.as_tensor(rng.integers(-2, k + 2, b).astype(np.int32)),
    )
    if cells:
        srv = rng.integers(-1, cells + 2, n)   # cloud and orphans too
        args["req_cell"] = torch.as_tensor(
            rng.integers(-1, cells + 2, b).astype(np.int32))
        args["srv_cell"] = torch.as_tensor(srv.astype(np.int32))
        args["spill"] = torch.as_tensor(rng.random((cells, cells)) < 0.5)
    knobs = dict(eta=f(rng.choice([0.0, 0.25, 0.5, 1.0, 0.3, 0.7], size=b)),
                 beta=torch.as_tensor(rng.random(b) < 0.5))
    return args, knobs


def _bits(x):
    return x.view({torch.float32: torch.int32, torch.float64: torch.int64,
                   torch.bfloat16: torch.int16}[x.dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_folding_by_hand_equals_the_knobs(dtype):
    """prompt*eta, work*eta and size -> +inf where beta is False, then the
    plain version, equals the plain version given eta and beta: the fold
    is the whole effect of the knobs (what the kernel does per row)."""
    args, knobs = _columns(1, 97, 13, 5, dtype, cells=3)
    eta, beta = knobs["eta"], knobs["beta"]
    by_hand = dict(args, prompt_bits=args["prompt_bits"] * eta,
                   work=args["work"] * eta,
                   size_bits=torch.where(beta, args["size_bits"], torch.inf))
    got = ref.route_score_ref(**by_hand)
    expect = ref.route_score_ref(**args, **knobs)
    assert torch.equal(_bits(got), _bits(expect))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_eta_product_rounds_like_apply_eta_beta(dtype):
    """The kernel multiplies in its compute type (float32 for bf16) and
    rounds to the columns' type once; apply_eta_beta multiplies in the
    columns' type. The two agree bit for bit, extremes included (a bf16
    product is exact in float32, so one rounding either way)."""
    rng = np.random.default_rng(7)
    fi = torch.finfo(dtype)
    x = torch.as_tensor(np.concatenate([
        rng.uniform(1e5, 1e12, 500), rng.uniform(0, 1, 100),
        [fi.max, fi.tiny, fi.tiny / 4, 0.0, -0.0, np.inf, 3.0e38]]))
    eta = torch.as_tensor(np.concatenate([
        rng.choice([0.0, 0.25, 0.5, 1.0, 0.3, 0.7], 500), rng.random(100),
        [1.0, 0.5, 0.3, 0.7, 0.25, 2.0, 0.0]]))
    x, eta = x.to(dtype), eta.to(dtype)
    compute = torch.promote_types(dtype, torch.float32)
    kernel_way = (x.to(compute) * eta.to(compute)).to(dtype)
    prompt, _, work = costs.apply_eta_beta(x, None, x, eta, None)
    assert torch.equal(_bits(kernel_way), _bits(prompt))
    assert torch.equal(_bits(kernel_way), _bits(work))


# ---------------------------------------- residency and spill as bit masks
def residency_bits(resident):
    """The kernel's residency mask of each server (K <= 32): bit i is
    ``resident[n, i]``."""
    k = resident.shape[1]
    weights = torch.tensor([1 << i for i in range(k)], dtype=torch.int64)
    return (resident.long() * weights).sum(dim=1)


def spill_rows(spill):
    """The kernel's spill mask row of each request cell (C <= 63): bit sc
    is ``spill[rc, sc]``, rc's own bit cleared."""
    c = spill.shape[0]
    weights = torch.tensor([1 << i for i in range(c)], dtype=torch.int64)
    rows = (spill.long() * weights).sum(dim=1)
    return rows & ~weights


def _gate(resident, model):
    """(B, N) residency gate read from the bit masks, model clamped."""
    k = resident.shape[1]
    m = model.long().clamp(0, k - 1)
    return ((residency_bits(resident)[None, :] >> m[:, None]) & 1).bool()


def _spilled(spill, req_cell, srv_cell):
    """(B, N) spilled pairs read from the mask rows: an out-of-range
    request cell has the empty row, an out-of-range server cell bit 63."""
    c = spill.shape[0]
    rc, sc = req_cell.long(), srv_cell.long()
    row = torch.where((rc >= 0) & (rc < c),
                      spill_rows(spill)[rc.clamp(0, c - 1)], 0)
    bit = torch.where((sc >= 0) & (sc < c), sc, 63)
    return ((row[:, None] >> bit[None, :]) & 1).bool()


@pytest.mark.parametrize("k", [1, 4, 9, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_residency_bit_mask_gates_like_the_byte_gather(k, dtype):
    args, _ = _columns(k, 80, 21, k, dtype)
    expect = ref.route_score_ref(**args)
    got = costs.edge_score_matrix(
        args["prompt_bits"], args["size_bits"], args["flops_tok"],
        args["work"], args["uplink_bps"], args["backhaul_bps"],
        args["flops_per_s"], queue_tokens=args["queue_tokens"],
        resident=_gate(args["resident"], args["model"]))
    assert torch.equal(_bits(got), _bits(expect))


@pytest.mark.parametrize("cells", [1, 3, 8, 63])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_spill_mask_rows_spill_like_the_byte_gather(cells, dtype):
    """Visibility and surcharge from the mask rows, over the plain
    version's cell-free scores, equal the plain version with cells and
    spill (cloud columns, orphan request and server cells included)."""
    args, _ = _columns(cells, 90, 40, 4, dtype, cells=cells)
    expect = ref.route_score_ref(**args, cloud_cell=-1)
    rc, sc = args.pop("req_cell"), args.pop("srv_cell")
    spill = args.pop("spill")
    base = ref.route_score_ref(**args)
    spilled = _spilled(spill, rc, sc)
    home = rc[:, None] == sc[None, :]
    visible = home | (sc[None, :] == -1) | spilled
    surcharge = args["prompt_bits"][:, None] / args["backhaul_bps"][None, :]
    got = torch.where(visible, base + torch.where(spilled, surcharge, 0.0),
                      torch.inf)
    assert torch.equal(_bits(got), _bits(expect))


# ------------------------------------------- what the wrapper hands the kernel
CPU = torch.device("cpu")


def _prepare(args, knobs=None, cloud_cell=-1):
    a = dict(queue_tokens=None, resident=None, model=None, req_cell=None,
             srv_cell=None, spill=None, eta=None, beta=None)
    a.update(args)
    a.update(knobs or {})
    return rs._prepare(
        CPU, 132, a["prompt_bits"], a["size_bits"], a["flops_tok"],
        a["work"], a["uplink_bps"], a["backhaul_bps"], a["flops_per_s"],
        a["queue_tokens"], a["resident"], a["model"], a["req_cell"],
        a["srv_cell"], a["spill"], a["eta"], a["beta"], cloud_cell)


ARG = dict(prompt=2, size=3, flops_tok=4, work=5, eta=6, uplink=7,
           backhaul=8, flops=9, queue=10, resident=11, beta=12, spill=13,
           model=14, req_cell=15, srv_cell=16)


def test_packed_arguments_follow_the_sources_enum():
    """_prepare packs the C entry point's int64 array in the order of the
    source's ``enum Arg``: every pointer, count and plan field where the
    kernel reads it, and every tensor pointed to kept alive."""
    src = (Path(rs.__file__).parent / "csrc" / "route_score.cu").read_text()
    names = re.search(r"enum Arg \{([^}]*)\}", src).group(1)
    names = [x.strip() for x in names.split(",") if x.strip()]
    assert names[-1] == "kArgs"
    idx = {name: i for i, name in enumerate(names[:-1])}
    args, knobs = _columns(8, 40, 12, 5, torch.float32, cells=3)
    out, a, keep = _prepare(args, knobs, cloud_cell=-1)
    assert len(a) == len(names) - 1
    p = rs.plan(40, 12, torch.float32, 132)
    for name, value in (("kOut", out.data_ptr()), ("kK", 5), ("kC", 3),
                        ("kCloud", -1), ("kRows", 40), ("kCols", 12),
                        ("kDirect", int(p.direct)), ("kBlocks", p.blocks),
                        ("kTx", p.tx), ("kTy", p.ty),
                        ("kColTiles", p.col_tiles),
                        ("kStripRows", p.strip_rows), ("kDevice", -1),
                        ("kPrompt", args["prompt_bits"].data_ptr()),
                        ("kEta", knobs["eta"].data_ptr()),
                        ("kBeta", knobs["beta"].data_ptr()),
                        ("kSpill", args["spill"].data_ptr()),
                        ("kSrvCell", args["srv_cell"].data_ptr())):
        assert a[idx[name]] == value, name
    for key, name in ARG.items():
        assert idx["k" + "".join(w.title() for w in key.split("_"))] == name
    pointed = {t.data_ptr() for t in keep if t is not None}
    assert {a[i] for i in range(2, 17) if a[i]} <= pointed


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_columns_in_the_kernels_types_pass_as_they_are(dtype):
    """No copy (so no cast launch on the card): float columns, eta in
    their type, bool masks as bytes and int32 ids reach the kernel at
    their own addresses."""
    args, knobs = _columns(3, 64, 16, 4, dtype, cells=3)
    out, a, keep = _prepare(args, knobs)
    assert out.dtype == dtype and out.shape == (64, 16)
    for name, col in (("prompt", "prompt_bits"), ("size", "size_bits"),
                      ("flops_tok", "flops_tok"), ("work", "work"),
                      ("uplink", "uplink_bps"), ("backhaul", "backhaul_bps"),
                      ("flops", "flops_per_s"), ("queue", "queue_tokens"),
                      ("resident", "resident"), ("spill", "spill"),
                      ("model", "model"), ("req_cell", "req_cell"),
                      ("srv_cell", "srv_cell")):
        assert a[ARG[name]] == args[col].data_ptr(), name
    assert a[ARG["eta"]] == knobs["eta"].data_ptr()
    assert a[ARG["beta"]] == knobs["beta"].data_ptr()
    assert a[0] == a[1] == rs._DTYPE_CODES[dtype]


def test_knobs_in_other_types_fold_on_the_host():
    """eta in float64 over float32 columns and a float beta: folded by
    apply_eta_beta first (as the plain version does), so the kernel gets
    no eta or beta and reads the folded columns, in float64 as the plain
    version computes."""
    args, knobs = _columns(4, 32, 8, 4, torch.float32)
    knobs = dict(eta=knobs["eta"].double(), beta=knobs["beta"].float())
    out, a, keep = _prepare(args, knobs)
    assert out.dtype == torch.float64 == ref.route_score_ref(
        **args, **knobs).dtype
    assert a[ARG["eta"]] == 0 and a[ARG["beta"]] == 0
    assert a[0] == rs._DTYPE_CODES[torch.float64]
    prompt = [t for t in keep if t is not None and
              t.data_ptr() == a[ARG["prompt"]]][0]
    torch.testing.assert_close(
        prompt, (args["prompt_bits"] * knobs["eta"]), rtol=0, atol=0)
    size = [t for t in keep if t is not None and
            t.data_ptr() == a[ARG["size"]]][0]
    assert torch.isinf(size[~knobs["beta"].bool()]).all()


def test_other_types_and_layouts_are_converted_once():
    args, _ = _columns(5, 32, 8, 4, torch.float32)
    args["model"] = args["model"].long()
    args["resident"] = args["resident"].to(torch.float32)
    strided = torch.zeros(16)
    strided[::2] = args["uplink_bps"]
    args["uplink_bps"] = strided[::2]
    out, a, keep = _prepare(args)
    assert a[ARG["model"]] != args["model"].data_ptr()
    assert a[ARG["resident"]] != args["resident"].data_ptr()
    assert a[ARG["uplink"]] != args["uplink_bps"].data_ptr()
    assert a[ARG["prompt"]] == args["prompt_bits"].data_ptr()
    held = [t for t in keep if t is not None]
    assert any(t.data_ptr() == a[ARG["uplink"]] and t.is_contiguous()
               for t in held)


@pytest.mark.parametrize("field,value,match", [
    ("model", torch.zeros(5, dtype=torch.int32), "model of shape"),
    ("req_cell", torch.zeros(5, dtype=torch.int32), "req_cell of shape"),
    ("srv_cell", torch.zeros(3, dtype=torch.int32), "srv_cell of shape"),
    ("spill", torch.zeros((3, 2), dtype=torch.bool), "spill of shape"),
    ("resident", torch.zeros((7, 4), dtype=torch.bool), "resident of shape"),
    ("resident", torch.zeros((8, 0), dtype=torch.bool), "resident of shape"),
    ("work", torch.zeros(5), "request column of shape"),
    ("queue_tokens", torch.zeros(5), "server column of shape"),
])
def test_wrong_shapes_raise_before_any_pointer_is_passed(field, value, match):
    args, _ = _columns(6, 32, 8, 4, torch.float32, cells=3)
    args[field] = value
    with pytest.raises(ValueError, match=match):
        _prepare(args)


def test_beta_without_size_raises_as_apply_eta_beta_does():
    args, knobs = _columns(7, 32, 8, 4, torch.float32)
    args["size_bits"] = None
    for beta in (knobs["beta"], knobs["beta"].float()):
        with pytest.raises(ValueError, match="beta"):
            _prepare(args, dict(beta=beta))
    with pytest.raises(ValueError, match="beta"):
        ref.route_score_ref(**args, beta=knobs["beta"])
