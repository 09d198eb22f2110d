"""Multi-rank cases of the port's mesh, run as a script by the
``tests/test_torch_{compression,train_mesh,lm_mesh,hlo_analysis}.py``
tests:

    python tests/torch_mesh_worker.py TASK WORLD OUTDIR

It spawns WORLD processes (``torch.multiprocessing``, spawn start) that
join a gloo process group through a ``file://`` store under OUTDIR (no
TCP port that two test workers could both take), run ``TASK`` on the CPU
and write their results under OUTDIR (rank 0 ``result.pt``; each rank
``rank<r>.pt`` where a task says so). A barrier precedes the group's
teardown. The tests compare the results with the port's mesh-free step
and the JAX package in their own process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import compression, sharding  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.models import train as train_mod  # noqa: E402

STEP_RUN = dict(batch=4, seq=32, steps=2)
RESUME_RUN = dict(batch=4, seq=32, log_every=100, device="cpu")
# (arch, mesh shape, parameters): "port" drawn by the port (seed 0), "ref"
# the JAX package's (``ref_params.npz``, written by the test)
MESH22_CASES = (("smollm_135m", (2, 2), "port"),
                ("mixtral_8x7b", (2, 2), "ref"),
                ("mixtral_8x7b", (1, 4), "ref"))
EP12_CASES = (("qwen3_moe_235b_a22b", (1, 2), "ref"),)
# run in the same world after MESH22_CASES: (arch, mesh shape, parameters,
# config overrides on top of ``reduced()``, ``seq`` that of the batch): a
# microbatched step under remat, the hybrid's shared block (used once
# after each group), 3 heads over a model axis of 2 (a forced head slice
# of a leaf stored whole over ``model``, the one kv head read by groups
# of 2 and 1), and a sequence ``model`` does not divide (the residual
# stream whole on every rank, the partials all-reduced); a vocab of 511,
# which ``model`` does not divide (the tied embedding whole on every
# rank), and ``cp_attention`` on the reference's parameters (the
# attention context-parallel over the rows); every other case's vocab of
# 512 is cut over ``model``
MESH22_VARIANTS = (("smollm_135m", (2, 2), "port",
                    {"remat": "full", "grad_accum": 2}),
                   ("zamba2_7b", (2, 2), "port", {}),
                   ("smollm_135m", (2, 2), "port",
                    {"num_heads": 3, "num_kv_heads": 1}),
                   ("smollm_135m", (2, 2), "port", {"seq": 31}),
                   ("smollm_135m", (2, 2), "port", {"vocab": 511}),
                   ("smollm_135m", (2, 2), "ref", {"cp_attention": True}))


def case_tag(arch, shape, overrides=None) -> str:
    """A case's key in the results: arch/DxM[/key=value...]."""
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    return tag + "".join(f"/{k}={v}" for k, v in (overrides or {}).items())


def psum_inputs(world: int) -> list:
    """Each rank's term: N(0, 1), (4, 250) (not a whole number of
    256-blocks)."""
    return [np.random.default_rng(r).standard_normal((4, 250))
            .astype(np.float32) for r in range(world)]


def task_psum(rank, world, out: Path):
    x = torch.from_numpy(psum_inputs(world)[rank])
    got = compression.compressed_psum(x)
    bf = compression.compressed_psum(x.to(torch.bfloat16))
    if rank == 0:
        torch.save({"f32": got, "bf16": bf}, out / "result.pt")


def case_run(overrides=None) -> dict:
    """``run_steps``'s keyword arguments of a case: ``STEP_RUN`` with the
    case's ``seq``."""
    run = dict(STEP_RUN)
    run["seq"] = (overrides or {}).get("seq", run["seq"])
    return run


def case_params(arch, source, out: Path, overrides=None):
    """(cfg, the port's model) of a case's parameters (the config
    overrides but ``seq``)."""
    overrides = {k: v for k, v in (overrides or {}).items() if k != "seq"}
    cfg = dataclasses.replace(reduced(get_arch(arch)), **overrides)
    if source == "port":
        return cfg, lm.init_params(torch.Generator().manual_seed(0), cfg)
    tree = {}
    with np.load(out / "ref_params.npz") as f:
        for key in f.files:
            if not key.startswith(arch + "/"):
                continue
            *path, leaf = key[len(arch) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return cfg, convert.params_from_jax(tree, cfg)


def run_steps(cfg, params, mesh, steps, batch, seq):
    """``steps`` train steps of ``params`` (``mesh=None``: mesh-free) on
    the pipeline's batches 0, 1, ...; returns the per-step (loss, grad
    norm), the model and the optimizer state."""
    opt_init, step_fn = train_mod.make_train_step(cfg, mesh=mesh)
    params.requires_grad_(True)
    opt = opt_init(params)
    dc = pipeline.DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    metrics = []
    for s in range(steps):
        params, opt, m = step_fn(params, opt,
                                 pipeline.synthetic_batch(cfg, dc, s,
                                                          device="cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, params, opt


@contextlib.contextmanager
def counted(*names):
    """Counts of the calls, while the block runs, of each of ``names``
    (``"lm.vocab_nll"``, ``"layers.cp_attend"``, ...: module attributes
    the mesh code calls through its module's globals)."""
    mods = {"lm": lm, "layers": layers}
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(mods[n.split(".")[0]], n.split(".")[1])
             for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(mods[n.split(".")[0]], n.split(".")[1], wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(mods[n.split(".")[0]], n.split(".")[1], fn)


def run_cases(cases, world, out: Path, rank: int):
    """Each case's steps over its mesh; per rank: each leaf's (local
    numel, numel, spec) and whether ``reshard_checkpoint_tree`` round
    trips the initial tree and splits it as ``distribute_tensor`` does;
    rank 0's result counts the calls of the vocab-parallel loss and the
    context-parallel attention."""
    result, mine = {}, {}
    for arch, shape, source, *over in cases:
        over = over[0] if over else None
        mesh = sharding.bind(sharding.make_mesh(
            shape, ("data", "model"), devices=["cpu"] * world))
        cfg, params = case_params(arch, source, out, over)
        specs = sharding.param_specs(params, cfg, mesh)
        start = {k: p.detach().clone() for k, p in params.named_parameters()}
        run = case_run(over)
        with counted("lm.vocab_nll", "layers.cp_attend") as calls:
            metrics, params, opt = run_steps(cfg, params, mesh,
                                             run.pop("steps"), **run)
        tag = case_tag(arch, shape, over)
        mine[tag] = {k: (p.to_local().numel(), p.numel(), specs[k])
                     for k, p in train_mod.named_params(params).items()}
        placed = ft.reshard_checkpoint_tree(start, specs, mesh)
        back = train_mod.full_tensors(placed)
        mine[tag + "/reshard"] = all(torch.equal(back[k], start[k])
                                     for k in start)
        mine[tag + "/reshard_split"] = all(torch.equal(
            placed[k].to_local(), distribute_tensor(
                start[k], mesh.groups, sharding.placements(specs[k], mesh),
                src_data_rank=None).to_local()) for k in start)
        params = train_mod.unshard(params)
        result[tag] = {"metrics": metrics, "calls": calls,
                       "params": {k: p.detach() for k, p in
                                  params.named_parameters()},
                       "mu": train_mod.full_tensors(opt.mu)}
    torch.save(mine, out / f"rank{rank}.pt")
    return result


def task_mesh22(rank, world, out: Path):
    """``MESH22_CASES`` and ``MESH22_VARIANTS`` over a world of 4; then a crash-resume through
    ``launch.train`` over the host mesh, (4, 1): 6 steps straight, and 3
    steps with a checkpoint followed by a run that resumes to 6."""
    result = run_cases(MESH22_CASES + MESH22_VARIANTS, world, out, rank)
    ckpt = out / "resume"
    _, full_run = launch.train("smollm_135m", steps=6, ckpt_dir=str(
        ckpt / "a"), ckpt_every=3, **RESUME_RUN)
    _, first = launch.train("smollm_135m", steps=3, ckpt_dir=str(ckpt / "b"),
                            ckpt_every=3, **RESUME_RUN)
    _, rest = launch.train("smollm_135m", steps=6, ckpt_dir=str(ckpt / "b"),
                           ckpt_every=3, **RESUME_RUN)
    result["resume"] = {"full": full_run, "first": first, "rest": rest}
    if rank == 0:
        torch.save(result, out / "result.pt")


def task_ep12(rank, world, out: Path):
    result = run_cases(EP12_CASES, world, out, rank)
    if rank == 0:
        torch.save(result, out / "result.pt")


# prefill + decode over a (1, WORLD) mesh (tests/test_torch_lm_mesh.py):
# (arch, parameters[, prompt length[, options]]); a prompt of 15 over a
# model axis of 2 keeps the rows whole. Options: ``cache``, the decode
# cache's slots (else prompt + decode); ``empty``, decode from an empty
# cache at position 0 (no prefill: the int8 cache takes no hand-off);
# any other key a config override. Over 2 ranks: Mamba's state by heads
# (mamba2, zamba2 with its shared block's cache slot a group); a prompt
# of 8 seated into a 20-slot cache, whose decode at 8-11 writes slots 8-9
# on rank 0 and 10-11 on rank 1 (at 8 rank 1 sees no key); a ring of 6
# slots (3 a rank) that wraps at position 18; 3 SSD heads over 2 (the
# state stored whole, ``conv_x``'s channel pieces not the heads'); 3 q
# heads and 1 kv head over 2 (the heads gathered unevenly, both ranks
# reading the one kv head). Every other case's vocab of 512 is cut over
# the ranks; a vocab of 511 stays whole on both; musicgen's four
# codebooks' tables and heads are cut alike; ``cp_attention`` prefills
# context-parallel (the ranks' queries over K/V gathered once) and
# decodes on the heads cut from the whole leaves
LM_MESH_CASES = (("smollm_135m", "port"), ("mixtral_8x7b", "ref"),
                 ("mixtral_8x7b", "ref", 15),
                 ("mamba2_2p7b", "ref"), ("zamba2_7b", "ref"),
                 ("smollm_135m", "ref", None,
                  {"empty": True, "kv_cache_dtype": "int8"}),
                 ("mixtral_8x7b", "ref", 8, {"cache": 20}),
                 ("mixtral_8x7b", "ref", 16, {"window": 6}),
                 ("mamba2_2p7b", "port", None,
                  {"d_model": 192, "ssm_head_dim": 128}),
                 ("smollm_135m", "port", None,
                  {"num_heads": 3, "num_kv_heads": 1}),
                 ("smollm_135m", "port", None, {"vocab": 511}),
                 ("musicgen_medium", "port"),
                 ("mixtral_8x7b", "ref", None, {"cp_attention": True}))
LM_PROMPT = dict(batch=2, seq=16, decode=4)
COUNT_PSUM_NUMEL = 1000   # the analysed all-reduce's float32 elements


def _lm_case(case) -> tuple:
    """(arch, parameters, prompt length or None, options)."""
    return tuple(case[:2]) + (case[2] if len(case) > 2 else None,
                              case[3] if len(case) > 3 else {})


def lm_case_tag(case) -> str:
    """An ``LM_MESH_CASES`` entry's key in the results: arch[/seq=S][/k=v
    for each option]."""
    arch, _, seq, opts = _lm_case(case)
    return arch + (f"/seq={seq}" if seq else "") + "".join(
        f"/{k}={v}" for k, v in opts.items())


def lm_case_id(case) -> str:
    """An ``LM_MESH_CASES`` entry's test id."""
    return "-".join([str(c) for c in case[:3]] + [
        f"{k}={v}" for k, v in _lm_case(case)[3].items()])


def lm_case_config(case, out: Path):
    """(cfg, the port's model, ``generate``'s keyword arguments) of an
    ``LM_MESH_CASES`` entry."""
    arch, source, seq, opts = _lm_case(case)
    over = {k: v for k, v in opts.items() if k not in ("cache", "empty")}
    cfg, params = case_params(arch, source, out, over)
    return cfg, params, dict(seq=seq, cache_len=opts.get("cache"),
                             empty=opts.get("empty", False))


def lm_prompt(cfg, seq=None):
    """The cases' prompt: numpy-drawn token ids (B, S), audio's (B, S,
    codebooks)."""
    shape = (LM_PROMPT["batch"], seq or LM_PROMPT["seq"])
    if cfg.modality == "audio":
        shape += (cfg.num_codebooks,)
    return np.random.default_rng(5).integers(0, cfg.vocab, shape).astype(
        np.int32)


def generate(cfg, params, mesh=None, seq=None, cache_len=None, empty=False):
    """Prefill of ``lm_prompt`` (``seq`` tokens, else ``LM_PROMPT``'s)
    seated into a decode cache of ``cache_len`` slots (else prompt +
    decode) then ``LM_PROMPT["decode"]`` greedy decode steps, over
    ``mesh`` (its parameters placed and gathered by their use layout, the
    cache in the decode layout) or without one: every step's logits and
    ids. ``empty``: no prefill; decode from an empty cache at position 0,
    from the prompt's first token."""
    prompt = torch.from_numpy(lm_prompt(cfg, seq))
    b, n = LM_PROMPT["batch"], LM_PROMPT["decode"]
    s = 0 if empty else prompt.shape[1]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        ctx = train_mod.gathered(params, train_mod.place_params(
            params, cfg, mesh), mesh)
    with ctx:
        cache = lm.init_cache(cfg, b, cache_len or s + n, device="cpu",
                              mesh=mesh)
        out_logits, out_ids = [], []
        if empty:
            tok = prompt[:, :1]
        else:
            ids, logits, part = lm.prefill(params, prompt, cfg, mesh=mesh)
            cache = lm.seat_cache(cache, part, mesh=mesh)
            out_logits, out_ids = [whole(logits)], [ids]
            tok = ids[:, -1:]
        for i in range(n):
            tok, logits, cache = lm.decode_step(params, cache, tok, s + i,
                                                cfg, mesh=mesh)
            out_logits.append(whole(logits))
            out_ids.append(tok)
    return {"logits": out_logits, "ids": out_ids}


def whole(logits):
    """Logits over the whole vocab: a mesh call's ``DTensor`` over
    ``model`` (the vocab cut over it) gathered (collective), else as
    they are."""
    return logits.full_tensor() if isinstance(logits, DTensor) else logits


def task_lm_mesh(rank, world, out: Path):
    mesh = sharding.bind(sharding.make_mesh(
        (1, world), ("data", "model"), devices=["cpu"] * world))
    result = {}
    for case in LM_MESH_CASES:
        cfg, params, kw = lm_case_config(case, out)
        with counted("lm.vocab_argmax", "layers.cp_attend") as calls:
            result[lm_case_tag(case)] = generate(cfg, params, mesh, **kw)
        result[lm_case_tag(case)]["calls"] = calls
    if rank == 0:
        torch.save(result, out / "result.pt")


def task_count_psum(rank, world, out: Path):
    """``hlo_analysis.analyze`` of ``sharding.all_reduce`` over the
    ``model`` axis of a (1, world) mesh."""
    from repro_torch.launch import hlo_analysis

    mesh = sharding.bind(sharding.make_mesh(
        (1, world), ("data", "model"), devices=["cpu"] * world))
    got = hlo_analysis.analyze(sharding.all_reduce,
                               torch.ones(COUNT_PSUM_NUMEL), mesh, ("model",))
    if rank == 0:
        torch.save(got, out / "result.pt")


TASKS = {"psum": task_psum, "mesh22": task_mesh22, "ep12": task_ep12,
         "lm_mesh": task_lm_mesh, "count_psum": task_count_psum}


def _entry(rank, task, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    try:
        TASKS[task](rank, world, out)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def spawn(task: str, world: int, out: Path, timeout: float = 300):
    """Run ``task`` over a gloo world of ``world`` ranks in a child
    process; returns rank 0's ``result.pt`` and every rank's own file (or
    ``None``)."""
    proc = subprocess.run([sys.executable, __file__, task, str(world),
                           str(out)], capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ))
    if proc.returncode:
        raise RuntimeError(f"torch_mesh_worker {task} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    mine = [out / f"rank{r}.pt" for r in range(world)]
    return (torch.load(out / "result.pt"),
            [torch.load(m) if m.exists() else None for m in mine])


if __name__ == "__main__":
    task, world, out = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])
    out.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(task, world, out), nprocs=world, join=True)
