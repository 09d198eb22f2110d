"""Full language model: embeddings -> layer stack -> norm -> head, with
``loss_fn`` (training), ``forward`` (teacher-forced), ``prefill``,
``init_cache`` and ``decode_step`` (serving). Port of
``repro/models/lm.py``.

Modality frontends, as in the reference:
  * text  — token embedding lookup.
  * audio — musicgen: (B, S, n_codebooks) EnCodec token ids; embedding =
    sum over per-codebook tables; one head per codebook.
  * image — pixtral: precomputed patch embeddings (B, S, d) from the stub
    ViT frontend (``patch_embeds``) are added to the token embeddings.

``init_params`` draws from a ``torch.Generator`` with the reference's
distributions and scales (not its numbers: ``jax.random`` is not
replayed); ``convert.params_from_jax`` carries the reference's own
parameters across. ``loss_fn`` records autograd through
``teacher_forced``; ``forward`` and the serving functions run without it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import layers, mamba2, transformer
from repro_torch.models.layers import dtype_of, param


class LanguageModel(nn.Module):
    """The reference's parameter tree: ``embed``, ``stack`` (see
    ``transformer.Stack``), ``final_norm`` and, unless tied (audio:
    always), ``head``."""

    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        dt, scale = dtype_of(cfg.param_dtype), cfg.d_model ** -0.5
        audio = cfg.modality == "audio"
        self.embed = param(
            gen, (cfg.num_codebooks, cfg.vocab, cfg.d_model) if audio
            else (cfg.vocab, cfg.d_model), dt, scale)
        self.stack = transformer.Stack(cfg, gen)
        self.final_norm = layers.RMSNorm(cfg)
        if audio:
            self.head = param(gen, (cfg.num_codebooks, cfg.d_model, cfg.vocab),
                              dt, scale)
        elif not cfg.tie_embeddings:
            self.head = param(gen, (cfg.d_model, cfg.vocab), dt, scale)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> LanguageModel:
    """Random parameters from ``gen``, drawn on the generator's device and
    left there (a CPU generator gives the same weights whatever device
    they move to; a CUDA one builds full-width weights on the card)."""
    with torch.no_grad():
        return LanguageModel(cfg, gen).to(gen.device).requires_grad_(False)


def embed(params, tokens, cfg: ArchConfig, patch_embeds=None, tp=None):
    """Token embeddings by ``F.embedding``: the reference's gather, and
    on the CPU its backward sums each row's gradients in a fixed order
    (an indexing backward's accumulation there is not). With ``tp`` (a
    ``sharding.ModelShard``) the embeddings are this rank's rows of the
    sequence, the residual stream's layout (whole where the sequence does
    not divide ``model``, as decode's one position). Over a mesh the
    table is taken for the lookup (``transformer.in_use``): where the
    vocab divides ``model`` it is this rank's vocab rows
    (``sharding.vocab_piece``), each rank looks up the whole sequence in
    them (``vocab_lookup``) and the partials are summed over ``model``
    into the rows (``sharding.scatter_seq``: a reduce-scatter, or an
    all-reduce where the rows stay whole). A text embedding is one value
    and zeros an element, so the sum is the whole table's lookup bit for
    bit; audio's sum over the codebooks is taken a rank at a time, so its
    association changes (float32 rounding)."""
    cd = dtype_of(cfg.compute_dtype)
    piece = sharding.vocab_piece(cfg, tp)
    if piece is None:
        tokens = sharding.seq_rows(tokens, tp)
        lookup = F.embedding
    else:
        def lookup(ids, table):
            return vocab_lookup(table, ids, piece[0])
    if patch_embeds is not None:
        patch_embeds = sharding.seq_rows(patch_embeds, tp)
    with transformer.in_use(params, ("embed",)):
        if cfg.modality == "audio":
            # tokens: (B, S, n_codebooks) — sum the per-codebook embeddings
            x = sum(lookup(tokens[..., c], params.embed[c])
                    for c in range(cfg.num_codebooks)).to(cd)
        else:
            x = lookup(tokens, params.embed).to(cd)
    if piece is not None:
        x = sharding.scatter_seq(x, tp)
    if cfg.modality == "image" and patch_embeds is not None:
        x = x + patch_embeds.to(cd)
    return x


def vocab_lookup(table, ids, start: int):
    """The rows of ``table`` (the vocab rows from ``start`` on) for
    ``ids``: an id outside them reads row 0 and its row is zeroed, so the
    ranks' lookups sum to the whole table's."""
    local = ids.long() - start
    mine = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(mine, local, 0), table)
    return rows.masked_fill(~mine[..., None], 0)


def unembed(params, x, cfg: ArchConfig):
    """Returns logits; audio: (B, S, C, V), else (B, S, V). Over a mesh
    whose ``model`` axis the vocab divides, the head (or the tied
    embedding) is this rank's vocab rows and the logits theirs: (..., V /
    m), a plain product, as the reference's head."""
    cd = dtype_of(cfg.compute_dtype)
    tied = cfg.modality != "audio" and cfg.tie_embeddings
    with transformer.in_use(params, ("embed",) if tied else ("head",)):
        if cfg.modality == "audio":
            return torch.einsum("bsd,cdv->bscv", x, params.head.to(cd))
        w = params.embed.T if tied else params.head
        return x @ w.to(cd)


def vocab_nll(logits, labels, start, reduce_max, reduce_sum):
    """Each position's cross-entropy, ``logsumexp - gold`` in float32,
    from logits over the vocab rows from ``start`` (``logits`` (..., n),
    ``labels`` (...)), the pieces of the vocab reduced by the callers'
    reductions: ``m = reduce_max(the local max)`` (detached: the result
    does not depend on it), ``(s, g) = reduce_sum(sum exp(logits - m), the
    gold logit where the label falls in the piece, else 0)``, ``m + log s
    - g``. ``sharding.model_reductions`` reduces across the ranks of
    ``model`` (one MAX and one packed SUM all-reduce); a stack of pieces
    on a leading dim (``start`` a tensor of their starts, broadcast) is
    reduced by a max and a sum over it. No (..., V) one-hot."""
    l32 = logits.float()
    m = reduce_max(l32.detach().amax(dim=-1))
    local = labels.long() - start
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(l32, -1, torch.where(mine, local, 0)[..., None])
    s, g = reduce_sum(torch.exp(l32 - m[..., None]).sum(dim=-1),
                      torch.where(mine, gold[..., 0], 0.0))
    return m + torch.log(s) - g


def vocab_argmax(logits, start, vocab: int, reduce_max, reduce_min):
    """Greedy ids over the whole vocab from logits over the vocab rows
    from ``start``: each piece's max and first index at it, ``m =
    reduce_max(max)``, then ``reduce_min`` of the global index among the
    pieces whose max is ``m`` (``vocab`` elsewhere): the lowest index at
    the largest logit, as ``torch.argmax`` over the whole vocab gives
    (the float32 max of bf16 logits is exact)."""
    top = logits.amax(dim=-1).float()
    first = logits.argmax(dim=-1) + start
    return reduce_min(torch.where(top == reduce_max(top), first, vocab))


def _greedy(logits, cfg: ArchConfig, tp):
    """(next ids, logits) of a serving call: over a ``model`` axis whose
    vocab divides it, the ids from the ranks' pieces (``vocab_argmax``)
    and the logits a ``DTensor`` over ``model`` holding this rank's
    (``sharding.vocab_dtensor``); else ``torch.argmax`` and the logits."""
    piece = sharding.vocab_piece(cfg, tp)
    if piece is None:
        return torch.argmax(logits, dim=-1), logits
    reduce_max, _, reduce_min = sharding.model_reductions(tp)
    ids = vocab_argmax(logits, piece[0], cfg.vocab, reduce_max, reduce_min)
    return ids, sharding.vocab_dtensor(logits, cfg, tp)


def _head(params, x, cfg: ArchConfig, tp):
    """The serving calls' last layer: the final norm, the head and the
    greedy ids of ``x`` (the positions served)."""
    with trace.span("lm.head"):
        x = layers.rmsnorm_apply(params.final_norm, x, cfg)
        return _greedy(unembed(params, x, cfg), cfg, tp)


def teacher_forced(params, tokens, cfg: ArchConfig, *, patch_embeds=None,
                   mesh=None):
    """Teacher-forced forward, recorded by autograd when grad mode is on
    (the stack checkpoints its blocks by ``cfg.remat``). Returns (logits,
    aux). ``mesh``: see ``transformer.stack_apply`` (the residual stream
    this rank's rows of the sequence over ``model``, gathered whole for
    the final norm and the head)."""
    tp = sharding.model_shard(mesh, tokens.shape[1])
    x = embed(params, tokens, cfg, patch_embeds, tp)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _, aux = transformer.stack_apply(params.stack, x, positions, cfg,
                                        mesh=mesh)
    x = layers.rmsnorm_apply(params.final_norm, sharding.gather_seq(x, tp),
                             cfg)
    return unembed(params, x, cfg), aux


@torch.no_grad()
def forward(params, tokens, cfg: ArchConfig, *, patch_embeds=None):
    """Teacher-forced forward without autograd. Returns (logits, aux)."""
    return teacher_forced(params, tokens, cfg, patch_embeds=patch_embeds)


def loss_fn(params, batch, cfg: ArchConfig, *, mesh=None, aux_weight=0.01):
    """Mean next-token cross-entropy (float32 log-softmax) + the MoE aux
    loss: ``(loss, {"nll", "aux"})``, float32 tensors. Audio averages over
    the codebooks too. The gold logit is a gather where the reference
    contracts with a one-hot (which keeps its vocab axis sharded): exactly
    one term of that sum is nonzero, so the value is the same, without a
    (B, S, V) float32 one-hot. Over a ``mesh`` the batch is this rank's
    rows and the loss their mean; where the vocab divides ``model`` each
    rank holds its piece of the logits and the logsumexp and the gold
    term cross the ranks (``vocab_nll``: a MAX and one packed SUM
    all-reduce, whose backward sums the ranks' equal gradients, so the
    rank's logits, its head rows and the stream carry the factor of the
    model size that ``models/train.py`` divides out)."""
    logits, aux = teacher_forced(params, batch["tokens"], cfg,
                                 patch_embeds=batch.get("patch_embeds"),
                                 mesh=mesh)
    tp = sharding.model_shard(mesh, batch["tokens"].shape[1])
    piece = sharding.vocab_piece(cfg, tp)
    if piece is None:
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, batch["labels"].long()[..., None])
        nll = (lse - gold[..., 0]).mean()
    else:
        reduce_max, reduce_sum, _ = sharding.model_reductions(tp)
        nll = vocab_nll(logits, batch["labels"], piece[0], reduce_max,
                        reduce_sum).mean()
    aux = torch.as_tensor(aux, dtype=torch.float32, device=nll.device)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def prefill(params, tokens, cfg: ArchConfig, *, patch_embeds=None,
            mesh=None):
    """Serving prefill: run the full prompt, build the KV/SSM cache, and
    return (next-token ids, last-position logits, caches). The K/V come
    back in the compute type, as the reference's do, also for an int8
    decode cache. ``mesh``: see ``transformer.stack_apply`` (``tokens``
    are this rank's batch rows, and ``params`` are placed and held under
    ``models.train.gathered``, which hands each block its leaves as it
    runs: the tensor-parallel slices, the residual stream this rank's
    rows of the sequence). Over a ``model`` axis above 1 the caches come
    back in the decode layout, ``DTensor``s over ``model`` holding this
    rank's pieces (``sharding.cache_dtensors``: the K/V sequence of the
    prompt, the Mamba state's heads and channels), and where the vocab
    divides ``model`` so do the logits: a ``DTensor`` holding this rank's
    piece of the vocab, the ids the whole vocab's (``vocab_argmax``)."""
    with trace.span("lm.prefill", batch=tokens.shape[0],
                    tokens=tokens.shape[1]):
        tp = sharding.model_shard(mesh, tokens.shape[1])
        x = embed(params, tokens, cfg, patch_embeds, tp)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, caches, _ = transformer.stack_apply(
            params.stack, x, positions, cfg, collect_cache=True, mesh=mesh)
        x = sharding.gather_seq(x, tp)
        ids, logits = _head(params, x[:, -1:], cfg, tp)
        if tp is not None:
            caches = sharding.cache_dtensors(caches, init_cache(
                cfg, tokens.shape[0], tokens.shape[1], device="meta"), cfg,
                tp)
    return ids, logits, caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None,
               mesh=None):
    """Per-layer caches sized for ``seq_len``, stacked on a leading layer
    axis (hybrid: nested, as ``transformer.stack_apply`` takes them).
    ``device=None`` is the CUDA card (raises without one). Over a
    ``mesh`` with a ``model`` axis above 1, ``batch`` is this rank's rows
    and the cache is in the decode layout, as ``prefill`` hands it off:
    only this rank's pieces (``sharding.cut_cache``) are allocated."""
    with trace.span("lm.init_cache"):
        device = resolve_device(device)
        tp = sharding.model_shard(mesh, 1)
        if tp is not None:
            whole = init_cache(cfg, batch, seq_len, device="meta")

            def zeros(tree):
                return {k: zeros(v) if isinstance(v, dict) else torch.zeros(
                    v.shape, dtype=v.dtype, device=device)
                    for k, v in tree.items()}

            return sharding.cache_dtensors(
                zeros(sharding.cut_cache(whole, cfg, tp)), whole, cfg, tp)

        def stacked(one, *lead):
            return {k: v.new_zeros(lead + v.shape) for k, v in one.items()}

        if cfg.family == "ssm":
            return stacked(mamba2.mamba_cache_init(cfg, batch, device=device),
                           cfg.num_layers)
        attn = layers.attention_cache_init(cfg, batch, seq_len, device=device)
        if cfg.family in ("dense", "moe"):
            return stacked(attn, cfg.num_layers)
        if cfg.family != "hybrid":
            raise ValueError(cfg.family)
        mamba = mamba2.mamba_cache_init(cfg, batch, device=device)
        n_groups, tail = divmod(cfg.num_layers, cfg.hybrid_period)
        out = {"groups": stacked(mamba, n_groups, cfg.hybrid_period),
               "shared_attn": stacked(attn, n_groups)}
        if tail:
            out["tail"] = stacked(mamba, tail)
        return out


@torch.no_grad()
def seat_cache(full, part, *, mesh=None):
    """Copy a prefill cache into the start of a longer one (the rest stays
    zero, as the reference's ``jnp.pad`` leaves it); returns ``full``.
    An int8 cache raises: prefill's K/V are in the compute type, and the
    reference has no quantising hand-off (a cast would truncate them).
    Over a ``mesh`` with a ``model`` axis above 1 both caches are in the
    decode layout (``prefill(mesh=)``, ``init_cache(mesh=)``), whose K/V
    pieces differ with the length: each layer's prompt K/V is gathered
    (one all-gather a leaf and layer) and each rank keeps the slots it
    owns in ``full``; the Mamba pieces are the same on both sides.
    Collective."""
    with trace.span("lm.seat_cache"):
        _seat(full, part, sharding.model_shard(mesh, 1))
    return full


def _seat(full, part, tp):
    for k, src in part.items():
        dst = full[k]
        if isinstance(dst, dict):
            _seat(dst, src, tp)
            continue
        if dst.dtype == torch.int8:
            raise ValueError(
                f"cannot seat a {src.dtype} prefill cache into the int8 "
                f"KV cache ({k!r}): prefill hands off compute-type K/V; "
                "decode from an empty int8 cache instead")
        if tp is None:
            dst[tuple(slice(0, n) for n in src.shape)] = src
        elif dst.shape == src.shape:        # the same pieces on both sides
            dst.to_local().copy_(src.to_local())
        else:
            _seat_pieces(dst, src, tp)


def _seat_pieces(dst, src, tp):
    """The prompt's slots of ``src`` into the ranks that own them in the
    longer ``dst`` (DTensors cut on the same dim over ``model``: the K/V
    sequence), a layer at a time: one all-gather of the layer's pieces,
    each rank keeping its own."""
    mine, theirs = dst.to_local(), src.to_local()
    d = dst.placements[0].dim - 1          # in one layer's leaf
    offset, n = sharding.seq_piece(dst.shape[d + 1], tp)
    length = src.shape[d + 1]
    keep = max(0, min(offset + n, length) - offset)
    for i in range(mine.shape[0]):
        whole = sharding.all_gather(theirs[i], sharding.Axis(
            tp.axis.group, tp.size, tp.index, d, length))
        mine[i].narrow(d, 0, keep).copy_(
            whole.narrow(d, min(offset, length), keep))


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig, *,
                patch_embeds=None, mesh=None):
    """One token for every sequence in the batch.

    tokens: (B, 1) (audio: (B, 1, C)); pos: the host int absolute position.
    Updates ``cache`` in place; returns (next ids, logits, cache).
    ``mesh``: as in ``prefill``; over a ``model`` axis above 1 ``cache``
    is in the decode layout (``prefill(mesh=)``, ``init_cache(mesh=)``,
    or placed by ``sharding.cache_specs``), each block runs on its
    tensor-parallel slices and no cache leaf is gathered; the logits as
    ``prefill``'s.
    """
    with trace.span("lm.decode_step", batch=tokens.shape[0], pos=pos):
        pieces, cache_len = cache, None
        tp = sharding.model_shard(mesh, 1)
        if tp is not None:
            pieces, cache_len = sharding.cache_pieces(cache)
        x = embed(params, tokens, cfg, patch_embeds, tp)
        positions = torch.full((1,), pos, dtype=torch.long,
                               device=tokens.device)
        x, _, _ = transformer.stack_apply(params.stack, x, positions, cfg,
                                          caches=pieces, pos=pos, mesh=mesh,
                                          cache_len=cache_len)
        ids, logits = _head(params, x, cfg, tp)
    return ids, logits, cache


def param_count(params) -> int:
    """Parameters of the model, each tensor once (a tied head is the
    embedding; zamba2's shared block is one module)."""
    return sum(p.numel() for p in params.parameters())
