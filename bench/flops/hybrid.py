"""Model flops of a prefill of the ``hybrid`` family: the Mamba2 layers
as ``flops/ssm.py`` counts them, and the shared block at each of its
``num_layers // hybrid_period`` applications: q, k, v and o projections,
attention over the causal half (4 head_dim a visible (query, key) pair
and head), the SwiGLU MLP (three products)."""
from bench.flops import ssm


def shared_block_flops(run, length):
    d, hd = run["d_model"], run["head_dim"]
    nh, nkv = run["num_heads"], run["num_kv_heads"]
    proj = 2 * d * hd * (2 * nh + 2 * nkv)
    mlp = 3 * 2 * d * run["d_ff"]
    attn = 4 * hd * nh * length * (length + 1) // 2
    return length * (proj + mlp) + attn


def prefill_flops(run, batch, length):
    applications = run["num_layers"] // run["hybrid_period"]
    return batch * (run["num_layers"] * ssm.mamba_layer_flops(run, length)
                    + applications * shared_block_flops(run, length)
                    + ssm.head_flops(run))
