"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake world of
256 ranks, on the CPU: fake tensors, a ``fake`` process group, no device.

* smollm-135m x ``train_4k`` and x ``decode_32k`` and mamba2-2.7b x
  ``prefill_32k`` on (16, 16) are ``ok``, depth cut to 2, 2 and 1 layers
  (the widths, the batch, the sequence and the mesh are the cell's);
* ``params`` (fake init only) equals the reference's parameter tree for
  all ten archs, and ``cfg.param_count()`` of both packages but for the
  leaves that formula omits on four archs (``FORMULA_GAP``);
* a cell's flops equal the analysis of the mesh-free step, prefill or
  decode at this rank's batch rows on a model whose blocks hold this
  rank's tensor-parallel slices (``sharding.tp_slice``: the shard bodies
  run whole-sequence, as the mesh runs them between ``gather_seq`` and
  ``scatter_seq``), the embedding and head the rank's piece of the vocab
  where it divides the model axis, else whole; for decode, with the
  mesh-free attention over the whole cache at the rank's heads replaced
  by the mesh's, every head over the rank's piece of the cache;
* the train cell's collective bytes equal the ring formula over its
  gathers on use (a block's twice under remat; the tensor-parallel
  leaves over ``data`` only), the reduce-scatters of their gradients,
  its bucketed sums of the replicated leaves, and the residual stream's
  gathers and reduce-scatters over ``model`` (each block's two bodies in
  the forward, the recompute and the backward; the final norm's),
  counted by hand from ``param_specs``; ``argument_bytes`` equals this
  rank's shards' bytes;
* llama3-405b x ``train_4k`` at 1 and 2 layers: a layer adds less to
  the peak than one block's whole leaves; llama3-405b x ``prefill_32k``
  at 1 layer peaks under an eighth of the whole-heads attention scores;
  llama3-405b x ``decode_32k`` at 1 layer makes no tensor as long as the
  whole cache and peaks under its arguments (the rank's piece of the
  cache among them), a block's slices and the head gathered whole;
* llama3-405b x ``long_500k`` is ``skipped`` with the reference's reason;
* every fake group is torn down after its cell.
"""
import dataclasses
import math
import types

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as rconf
from repro.models import lm as j_lm
from repro_torch import configs as tconf
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import lm, train

# (arch, shape, depth cut)
CELLS = (("smollm-135m", "train_4k", 2), ("smollm-135m", "decode_32k", 2),
         ("mamba2-2.7b", "prefill_32k", 1))
DATA = MODEL = 16


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {(arch, shape): dryrun.run_cell(
        arch, shape, multi_pod=False, overrides={"num_layers": layers},
        results_dir=out, verbose=False) for arch, shape, layers in CELLS}
    assert not dist.is_initialized()
    return recs


@pytest.mark.parametrize("arch,shape,layers", CELLS)
def test_cells_are_ok(records, arch, shape, layers):
    rec = records[arch, shape]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["mesh"] == "pod16x16"
    assert rec["overrides"] == {"num_layers": layers}
    assert set(rec["hlo"]) >= {"flops", "hbm_bytes", "collective_bytes",
                               "collective_counts"}
    assert rec["trace_s"] > 0 and rec["note"] == dryrun.NOTE
    assert rec["memory"]["peak_device_bytes"] \
        >= rec["memory"]["argument_bytes"] > 0
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["collective_bytes"] > 0


def test_records_land_in_build_dryrun():
    assert dryrun.RESULTS_DIR.parts[-2:] == ("build", "dryrun")
    assert "benchmarks" not in dryrun.RESULTS_DIR.parts


# leaves that ``ArchConfig.param_count()`` leaves out, in both packages:
# qwen3's q/k-norm scales; small Mamba2 leaves (mamba2, zamba2)
FORMULA_GAP = {"qwen3_32b": 16384, "qwen3_moe_235b_a22b": 24064,
               "mamba2_2p7b": 180224, "zamba2_7b": 300672}


@pytest.mark.parametrize("arch", rconf.list_archs())
def test_params_are_the_reference_trees_and_the_configs_counts(arch):
    """``params`` (from the fake leaves) equals the reference's parameter
    tree, leaf for leaf in sum, for all ten archs; and the configs'
    ``param_count()`` of both packages, but for the leaves that formula
    omits (``FORMULA_GAP``: a finding about the formula, the same in both
    packages). ``active_params`` likewise."""
    cfg, ref = tconf.get_arch(arch), rconf.get_arch(arch)
    with FakeTensorMode():
        total, active = dryrun.param_counts(lm.LanguageModel(cfg), cfg)
    tree = jax.eval_shape(lambda: j_lm.init_params(jax.random.key(0), ref))
    assert total == sum(math.prod(x.shape) for x in jax.tree.leaves(tree))
    gap = FORMULA_GAP.get(arch, 0)
    assert total - gap == cfg.param_count() == ref.param_count()
    assert active - gap == cfg.active_param_count() \
        == ref.active_param_count()


def test_long_context_on_full_attention_is_skipped(tmp_path):
    rec = dryrun.run_cell("llama3-405b", "long_500k", multi_pod=False,
                          results_dir=tmp_path, verbose=False)
    ok, why = rconf.shape_applicable(rconf.get_arch("llama3-405b"),
                                     "long_500k")
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == why


def _local_rows(cfg, shape):
    """This rank's rows of the cell's inputs, as fake tensors."""
    sh = tconf.SHAPES[shape]
    rows = sh["global_batch"] // DATA
    return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype)
            for k, v in tconf.input_specs(cfg, shape).items()}


def _rank_slices(params, cfg, index):
    """``params`` with each block leaf cut to model rank ``index``'s
    tensor-parallel slice (``sharding.tp_slice`` over ``MODEL``), and the
    embedding and the head to its piece of the vocab where the vocab
    divides ``MODEL`` (their ``model`` shard, ``sharding.vocab_piece``),
    in place."""
    vocab = sharding.vocab_piece(
        cfg, types.SimpleNamespace(index=index, size=MODEL))
    for name, p in list(params.named_parameters()):
        piece = sharding.tp_slice(name, cfg, index, MODEL)
        if vocab is not None and name in ("embed", "head"):
            piece = (p.dim() - (2 if name == "embed" else 1),) + vocab
        if piece is not None:
            dim, lo, hi = piece
            owner, _, leaf = name.rpartition(".")
            params.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
                p.detach().narrow(dim, lo, hi - lo).clone())
    return params


@pytest.mark.parametrize("arch,shape,layers", CELLS)
def test_flops_are_the_mesh_free_call_at_the_local_rows(records, arch, shape,
                                                        layers):
    """Rank 0 of the (16, 16) mesh: smollm-135m's one q head of nine and
    the kv head it reads, its 96 of 1536 ``ff`` columns, its 3072 of the
    49152 rows of the tied embedding (the head's products a sixteenth);
    mamba2-2.7b's 5 of 80 SSD heads, its head whole (50280 does not
    divide 16)."""
    cfg = tconf.get_arch(arch, num_layers=layers)
    sh = tconf.SHAPES[shape]
    with FakeTensorMode():
        params = lm.LanguageModel(cfg)
        if sh["kind"] != "decode":
            _rank_slices(params, cfg, 0)
        rows = _local_rows(cfg, shape)
        if sh["kind"] == "train":
            params.requires_grad_(True)
            opt_init, step = train.make_train_step(cfg)
            got = hlo_analysis.analyze(step, params, opt_init(params), rows)
        elif sh["kind"] == "prefill":
            got = hlo_analysis.analyze(lm.prefill, params.requires_grad_(False),
                                       rows["tokens"], cfg)
        else:
            got = _mesh_free_decode(params, cfg, rows, sh["seq_len"])
    assert records[arch, shape]["hlo"]["flops"] == got["flops"]
    assert records[arch, shape]["hlo"]["by_op"] == got["by_op"]


def _mesh_free_decode(params, cfg, rows, seq):
    """The mesh-free decode at the rows on rank 0's slices (its cache of
    the kv heads its q heads read, over every slot), its attention over
    the whole cache at its heads swapped for the mesh's: every head over
    the rank's ``seq / MODEL`` slots (``ops.decode_attention_partial``,
    counted as the reference's decode at those keys)."""
    _rank_slices(params, cfg, 0)
    kv0, kv1 = sharding.kv_heads_of(cfg, 0, MODEL)
    cache = lm.init_cache(dataclasses.replace(cfg, num_kv_heads=kv1 - kv0),
                          rows["tokens"].shape[0], seq, device="cpu")
    got = hlo_analysis.analyze(lm.decode_step, params.requires_grad_(False),
                               cache, rows["tokens"], seq - 1, cfg)
    local = got["by_op"].pop("ops.decode_attention")
    b, h, d = rows["tokens"].shape[0], cfg.num_heads, cfg.head_dim
    mine = cfg.num_layers * hlo_analysis.kernel_flops(
        "decode_attention_partial",
        {"q": torch.empty(b, 1, h, d), "k": torch.empty(b, seq // MODEL, 1, d)})
    got["by_op"]["ops.decode_attention_partial"] = mine
    got["flops"] += mine - local
    return got


def _smollm_layout():
    """smollm-135m (2 layers) at train_4k on (16, 16): each parameter's
    (numel, spec), its dtype's bytes, and the batch rows' bytes."""
    cfg = tconf.get_arch("smollm-135m", num_layers=2)
    mesh = sharding.make_mesh((DATA, MODEL), ("data", "model"),
                              devices=["cpu"] * (DATA * MODEL))
    with FakeTensorMode():
        params = lm.LanguageModel(cfg)
        specs = sharding.param_specs(params, cfg, mesh)
        leaves = {k: (p.numel(), p.shape, specs[k])
                  for k, p in params.named_parameters()}
    rows = tconf.SHAPES["train_4k"]["global_batch"] // DATA
    return cfg, leaves, rows * tconf.SHAPES["train_4k"]["seq_len"] * 4 * 2


def _shards(shape, spec):
    """How many pieces of the (16, 16) mesh a leaf of ``spec`` is cut
    into, each dimension dividing evenly."""
    n = 1
    for d, entry in zip(shape, spec):
        if entry is not None:
            assert d % 16 == 0
            n *= 16
    return n


def test_argument_bytes_are_the_local_shards(records):
    cfg, leaves, batch_bytes = _smollm_layout()
    per = 2 + 4 + 4        # bf16 parameter, float32 moments
    assert cfg.param_dtype == "bfloat16" and cfg.moment_dtype == "float32"
    local = sum(n // _shards(shape, spec) for n, shape, spec in leaves.values())
    rec = records["smollm-135m", "train_4k"]
    assert rec["memory"]["argument_bytes"] == local * per + batch_bytes


def test_train_collectives_are_the_ring_formula_by_hand(records):
    """Each leaf sharded on the mesh is all-gathered at each use, axis by
    axis in mesh order (over both axes: the first gather's output a
    sixteenth of the leaf, the second's the whole leaf; a tensor-parallel
    leaf whose ``model`` shard is its body's slice, the MLP's here, and
    the tied embedding, whose ``model`` shard is the rank's vocab rows,
    over ``data`` only: a sixteenth), each microbatch: a block's leaves
    twice under ``remat="full"`` (the forward and the recompute), the tied
    embedding once at the lookup and once at the head. Each use's
    gradient is reduce-scattered back in reverse order (over both axes: a
    sixteenth of the leaf, then a 256th), at the reference's ``g - 1`` on
    the scattered output. The shard-sized gradients of the leaves
    replicated over an axis are all-reduced over it in their bucket (the
    attention's, stored whole over ``model`` since 9 heads do not divide
    16, each rank's slice among zeros); then the grad norm's float32
    scalar over both axes, and the loss, nll and aux over ``data``. Over
    ``model`` the residual stream moves: each block's two bodies gather
    the (16, 4096, 576) bf16 sequence from the rows and reduce-scatter
    their partials back, in the forward and again in the recompute (which
    stops once it has rebuilt what the backward reads: the MLP partial's
    reduce-scatter is not run again), and the backward does the
    conjugates (a reduce-scatter for each gather, an all-gather for each
    reduce-scatter); the final norm's gather once each way; the
    embedding's partial lookup (the whole sequence in the rank's vocab
    rows) reduce-scattered into the rows, and its gradient all-gathered
    back. The loss crosses the ranks' pieces of the vocab in float32, a
    value a token: a MAX all-reduce, and the packed sum of two
    all-reduced forward and again in the backward."""
    cfg, leaves, _ = _smollm_layout()
    assert cfg.remat == "full" and cfg.tie_embeddings
    ring_ag, ring_rs, ring_ar = 15 / 16, 15, 2 * 15 / 16
    rows = tconf.SHAPES["train_4k"]["global_batch"] // DATA
    act = rows * tconf.SHAPES["train_4k"]["seq_len"] * cfg.d_model * 2
    gather = cfg.grad_accum * (6 * cfg.num_layers + 2) * act * ring_ag
    scatter = cfg.grad_accum * (5 * cfg.num_layers + 2) * act / MODEL * ring_rs
    reduce = 0.0
    for name, (n, shape, spec) in leaves.items():
        full, pieces = n * 2, _shards(shape, spec)
        uses = 2 if name == "embed" else 1
        passes = 2 if name.startswith("stack.") else 1
        if pieces == DATA * MODEL and (name == "embed" or sharding.tp_slice(
                name, cfg, 0, MODEL)):
            gathered, scattered = full / MODEL, full / pieces
        elif pieces == DATA * MODEL:
            gathered, scattered = full / MODEL + full, full / MODEL + full / pieces
        elif pieces > 1:
            gathered, scattered = full, full / pieces
        else:
            gathered = scattered = 0.0
        gather += cfg.grad_accum * uses * passes * gathered * ring_ag
        scatter += cfg.grad_accum * uses * scattered * ring_rs
        replicated = 2 - sum(e is not None for e in spec)
        reduce += replicated * full / pieces * ring_ar
    tokens = rows * tconf.SHAPES["train_4k"]["seq_len"]
    reduce += cfg.grad_accum * (1 + 2 + 2) * tokens * 4 * ring_ar
    reduce += (2 + 3) * 4 * ring_ar
    counts = records["smollm-135m", "train_4k"]["hlo"]["collective_counts"]
    assert set(counts) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert counts["all-gather"] == pytest.approx(gather, rel=1e-12)
    assert counts["reduce-scatter"] == pytest.approx(scatter, rel=1e-12)
    assert counts["all-reduce"] == pytest.approx(reduce, rel=1e-12)


def test_a_train_step_holds_one_block_whole_at_a_time(tmp_path):
    """llama3-405b x ``train_4k`` on (16, 16) at 1 and 2 layers: the
    second layer adds less to the per-rank peak than one block's whole
    bf16 leaves (~5.9 GiB), since a block's leaves are gathered as it runs
    and dropped after. Gathering the whole model for the step added about
    four such copies a layer."""
    peaks = []
    for layers in (1, 2):
        rec = dryrun.run_cell("llama3-405b", "train_4k", multi_pod=False,
                              overrides={"num_layers": layers},
                              results_dir=tmp_path / str(layers),
                              verbose=False)
        assert rec["status"] == "ok", rec.get("trace")
        peaks.append(rec["memory"]["peak_device_bytes"])
    cfg = tconf.get_arch("llama3-405b", num_layers=1)
    with FakeTensorMode():
        block = lm.LanguageModel(cfg).stack.blocks[0]
        whole = sum(p.numel() * p.element_size() for p in block.parameters())
    assert cfg.param_dtype == "bfloat16"
    assert 0 < peaks[1] - peaks[0] < whole


def test_prefill_shards_attention_heads_over_model(tmp_path):
    """llama3-405b x ``prefill_32k`` on (16, 16) at 1 layer: each rank's
    attention runs 8 of the 128 heads over its 2 rows of the whole 32768
    positions (the kernel's flops at those shapes), and the rank peaks
    under an eighth of the whole-heads float32 scores (2, 128, 32768,
    32768); with whole heads on every rank the trace held two such
    tensors at once."""
    rec = dryrun.run_cell("llama3-405b", "prefill_32k", multi_pod=False,
                          overrides={"num_layers": 1}, results_dir=tmp_path,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("trace")
    cfg = tconf.get_arch("llama3-405b")
    sh = tconf.SHAPES["prefill_32k"]
    rows, s = sh["global_batch"] // DATA, sh["seq_len"]
    heads = cfg.num_heads // MODEL
    assert rec["hlo"]["by_op"]["ops.attention"] == \
        4.0 * rows * heads * s * s * cfg.head_dim
    scores = rows * cfg.num_heads * s * s * 4
    assert rec["memory"]["peak_device_bytes"] < scores / 8


def test_decode_holds_the_cache_in_its_sequence_pieces(tmp_path):
    """llama3-405b x ``decode_32k`` on (16, 16) at 1 layer: each rank's 8
    rows over its 2048 of the 32768 slots. No tensor of the step spans
    the whole sequence (a K/V leaf gathered over ``model`` would) or the
    whole vocab (the embedding, the head or the logits whole would), and
    the rank peaks under its arguments (its piece of the cache, 64 MiB,
    among them) plus a block's leaves as its gathers hold them (each its
    ``model`` shard, gathered over ``data``; ``wk``/``wv``, whose 8 kv
    heads do not divide 16, whole before the cut to the rank's head)
    plus the head's ``model`` shard, its vocab rows gathered over
    ``data`` (a sixteenth of the head). Decode once gathered every cache
    leaf whole and ran every block whole (207.7 GiB a rank at 126
    layers), and then the head whole, with two of its ``model`` pieces
    in flight in the gather: a bound of the head and a ninth more."""
    from torch.utils._python_dispatch import TorchDispatchMode

    sh = tconf.SHAPES["decode_32k"]
    cfg = tconf.get_arch("llama3-405b", num_layers=1)
    widest = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dim():
                    widest.append(max(t.shape))
            return out

    rec = dryrun.run_cell("llama3-405b", "decode_32k", multi_pod=False,
                          overrides={"num_layers": 1}, results_dir=tmp_path,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("trace")
    with dryrun.fake_world(DATA * MODEL):
        mesh = sharding.bind(dryrun.make_production_mesh(device="cpu"))
        with FakeTensorMode():
            fn, args, *_ = dryrun.build_cell("llama3-405b", "decode_32k",
                                             mesh, {"num_layers": 1})
            piece = args[1]["k"].to_local().shape
            with Shapes():
                fn(*args)
    assert piece[1:3] == (sh["global_batch"] // DATA, sh["seq_len"] // MODEL)
    assert sh["seq_len"] not in widest
    assert sh["seq_len"] // MODEL in widest      # the scores over the piece
    assert cfg.vocab not in widest
    assert cfg.vocab // MODEL in widest          # the rank's logits
    grid = sharding.make_mesh((DATA, MODEL), ("data", "model"),
                              devices=["cpu"] * (DATA * MODEL))
    with FakeTensorMode():
        model = lm.LanguageModel(cfg)
        specs = sharding.param_specs(model, cfg, grid)
        held = {k: p.numel() * p.element_size() // (
            MODEL if "model" in specs[k] else 1)
            for k, p in model.named_parameters()}
    block = sum(n for k, n in held.items() if k.startswith("stack."))
    assert held["head"] * MODEL == cfg.d_model * cfg.vocab * 2
    bound = rec["memory"]["argument_bytes"] + block + held["head"]
    assert rec["memory"]["peak_device_bytes"] < bound


def test_decode_under_cp_attention_keeps_the_rank_heads(tmp_path):
    """llama3-405b x ``decode_32k`` on (16, 16) at 1 layer, with
    ``cp_attention`` and without: the same collectives, bytes and peak.
    Decode splits the heads either way (the reference's decode ignores the
    flag), so each block gathers ``wq``/``wo`` as their ``model`` shards
    over ``data`` only; only a context-parallel call (prefill or train
    over the rank's rows) gathers the attention's leaves whole. Gathering
    them whole for decode too cost 3.3x the collective bytes at 126
    layers."""
    recs = [dryrun.run_cell("llama3-405b", "decode_32k", multi_pod=False,
                            overrides={"num_layers": 1, **extra}, tag=tag,
                            results_dir=tmp_path, verbose=False)
            for tag, extra in (("split", {}),
                               ("cp", {"cp_attention": True}))]
    for rec in recs:
        assert rec["status"] == "ok", rec.get("trace")
    split, cp = recs
    for key in ("collective_bytes", "collective_counts", "flops"):
        assert cp["hlo"][key] == split["hlo"][key], key
    assert cp["memory"] == split["memory"]


def test_microbatches_smaller_than_the_batch_shards_run_whole(tmp_path):
    """The multi-pod mesh has 32 batch shards: ``train_4k``'s 256 rows in
    16 microbatches of 16 do not divide over them, so every rank runs each
    microbatch whole, as the reference's step does (its global batch split
    first; the batch constraint dropped where it does not divide), each
    block on rank 0's tensor-parallel slices. The step once failed here,
    splitting 8 local rows into 16."""
    over = {"num_layers": 1, "grad_accum": 16}
    rec = dryrun.run_cell("smollm-135m", "train_4k", multi_pod=True,
                          overrides=over, results_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok", rec.get("trace")
    cfg = tconf.get_arch("smollm-135m", **over)
    with FakeTensorMode():
        params = _rank_slices(lm.LanguageModel(cfg), cfg, 0)
        params.requires_grad_(True)
        opt_init, step = train.make_train_step(cfg)
        batch = tconf.input_specs(cfg, "train_4k", device="cpu")
        got = hlo_analysis.analyze(step, params, opt_init(params), batch)
    assert rec["hlo"]["flops"] == got["flops"]
