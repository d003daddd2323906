"""``ssd_chunk``: Mamba-2's recurrence over a prompt, B rows of S tokens.

Shape: ``B`` (the rows launched: the batch bucket), ``S``, ``H`` heads of
``P`` channels, a state of ``N``, ``elem`` (x, B, C, dt and y),
``state_out`` (whether the last state is written, float32). Operations:
5 H P N a token (the state's decay, its outer-product update and the sum
S C). Bytes: x, dt, B and C read once, y written once, and the last state
when it is written. The served prefill (``Transformer.last_logits``)
writes none.

The model's sizes: granite-4.0-h-micro's, the only configuration that
runs the kernel: an inner width of 2 d_model in heads of 64, a state of
128, and 9 Mamba-2 layers in each period of 10.
"""
MATCH = r"ssd_chunk_(cb|state|carry|out)_kernel"
HEAD_DIM, STATE, EXPAND = 64, 128, 2
MAMBA_SHARE = (9, 10)  # Mamba-2 layers in a period of layers


def launch_shapes(job, model):
    """A prefill: one launch a Mamba-2 layer over the bucket's rows."""
    if job.kind != "prefill":
        return []
    h = EXPAND * model["d_model"] // HEAD_DIM
    layers = model["n_layers"] * MAMBA_SHARE[0] // MAMBA_SHARE[1]
    shape = dict(B=job.bucket, S=job.length, H=h, P=HEAD_DIM, N=STATE, state_out=False)
    return [shape] * layers


def launch_cost(shape):
    b, s, h, p, n = shape["B"], shape["S"], shape["H"], shape["P"], shape["N"]
    e = shape.get("elem", 2)
    flops = 5 * b * s * h * p * n
    nbytes = b * s * (2 * h * p + h + 2 * n) * e
    if shape.get("state_out"):
        nbytes += b * h * p * n * 4
    return float(flops), float(nbytes)
