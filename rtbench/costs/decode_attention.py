"""``decode_attention``: one query token per row against its KV cache.

Shape: ``ctx`` (the cache length each ACTIVE row attends to, cursor + 1;
inactive and dead rows are skipped whole by the kernel), ``H`` query
heads, ``KV`` cache heads, ``D`` head size, ``elem`` bytes per element.
Per active row: 4 H D ctx operations (scores and the weighted sum),
and K and V of its ctx positions read, q read and the output written.
"""
MATCH = r"decode_(mma|fma|combine)_kernel"


def launch_shapes(job, model):
    """A decode step: one launch a layer over its active rows' contexts."""
    if job.kind != "decode" or not job.ctx:
        return []
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    shape = dict(ctx=job.ctx, H=model["n_heads"], KV=model["n_kv_heads"], D=hd)
    return [shape] * model["n_layers"]


def launch_cost(shape):
    h, kv, d, e = shape["H"], shape["KV"], shape["D"], shape.get("elem", 2)
    ctx = list(shape["ctx"])
    flops = sum(4 * h * d * c for c in ctx)
    nbytes = sum(2 * c * kv * d * e for c in ctx) + len(ctx) * 2 * h * d * e
    return float(flops), float(nbytes)
