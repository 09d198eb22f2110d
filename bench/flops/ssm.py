"""Model flops of a prefill of the ``ssm`` family: 2 m n k for every
product of the model's own equations, counted from the configuration's
``run`` and the call's (batch, length). Per Mamba2 layer and token: the
in-projection to z, x, B, C and dt, the out-projection; the SSD at the
configuration's chunk length (within a chunk the causal half of C B^T and
of its product with x, across chunks C against the state and the state's
update); the head on the last position only, as prefill computes it.
Norms, the convolution and element-wise work are not counted."""


def ssd_flops(run, length):
    d_inner = run["ssm_expand"] * run["d_model"]
    n, q = run["ssm_state"], run["ssm_chunk"]
    total = 0
    for t0 in range(0, length, q):
        c = min(q, length - t0)
        pairs = c * (c + 1) // 2
        total += 2 * pairs * n + 2 * pairs * d_inner + 4 * c * d_inner * n
    return total


def mamba_layer_flops(run, length):
    d, n = run["d_model"], run["ssm_state"]
    d_inner = run["ssm_expand"] * d
    heads = d_inner // run["ssm_head_dim"]
    proj = 2 * d * (2 * d_inner + 2 * n + heads) + 2 * d_inner * d
    return length * proj + ssd_flops(run, length)


def head_flops(run):
    return 2 * run["d_model"] * run["vocab"]


def prefill_flops(run, batch, length):
    return batch * (run["num_layers"] * mamba_layer_flops(run, length)
                    + head_flops(run))
