"""``wkv6``: the RWKV-6 recurrence over B rows of S tokens, H heads.

Shape: ``B``, ``S``, ``H``, ``K``, ``V``, ``elem`` (r, k, v, u and the
output), ``w_elem`` (the decay, float32 in the port), ``state_in``
(whether a float32 state is read; the new state is always written).
Operations: 7 K V a token and head (k^T v, the decayed state and its
sum, the bonus term, and r against the state). Bytes: r, k, v, w, u and
the state in read once, the output and the state out written once.
"""
MATCH = r"\bwkv6_kernel|wkv6_chunk_(state|carry|out)_kernel"


def launch_shapes(job, model):
    """One launch a layer: a prefill over the bucket's rows from a zero
    state, a decode step over the arena's rows from their states."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    if job.kind == "prefill":
        shape = dict(B=job.bucket, S=job.length, H=model["n_heads"], K=hd, V=hd, state_in=False)
    else:
        shape = dict(B=job.bucket, S=1, H=model["n_heads"], K=hd, V=hd, state_in=True)
    return [shape] * model["n_layers"]


def launch_cost(shape):
    b, s, h, k, v = shape["B"], shape["S"], shape["H"], shape["K"], shape["V"]
    e, we = shape.get("elem", 2), shape.get("w_elem", 4)
    flops = 7 * b * s * h * k * v
    state = b * h * k * v * 4
    nbytes = (b * s * h * (2 * k + v) * e + b * s * h * k * we + h * k * e
              + b * s * h * v * e + state + (state if shape.get("state_in") else 0))
    return float(flops), float(nbytes)
