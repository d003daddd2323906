"""``flash_attention``: causal attention over a prompt, B rows of S tokens.

Shape: ``B`` (the rows launched: the batch bucket), ``S``, ``H``,
``KV``, ``D``, ``elem``, ``causal``. Operations: 4 H D per (query, key)
pair the mask keeps, S (S + 1) / 2 pairs a row when causal. Bytes: q,
k and v read once and the output written once.
"""
MATCH = r"flash_(wgmma|fma)_kernel"


def launch_shapes(job, model):
    """A prefill: one launch a layer over the bucket's rows."""
    if job.kind != "prefill":
        return []
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    shape = dict(B=job.bucket, S=job.length, H=model["n_heads"], KV=model["n_kv_heads"], D=hd)
    return [shape] * model["n_layers"]


def launch_cost(shape):
    b, s, h, kv, d = shape["B"], shape["S"], shape["H"], shape["KV"], shape["D"]
    e = shape.get("elem", 2)
    pairs = s * (s + 1) // 2 if shape.get("causal", True) else s * s
    flops = 4 * b * h * d * pairs
    nbytes = b * s * (2 * h + 2 * kv) * d * e
    return float(flops), float(nbytes)
