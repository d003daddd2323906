"""``ssd_step``: one decode token of Mamba-2's mixer over the arena's rows.

Shape: ``rows`` (the rows the step advances: a held or dead row is not
touched), ``H`` heads of ``P`` channels, a state of ``N``, ``C`` conv
channels (H P + 2 N), ``W`` the conv width, ``elem``. Operations: 5 H P N
a row (as ``ssd_chunk``'s token). Bytes, the bound: each stepped row's
float32 state read and written once (2 H P N x 4: 134 MB at 32 rows of
granite-4.0-h-micro), its float32 conv window read and written, its
token's conv inputs and dt read and y written; the conv weights once.

The model's sizes as in ``ssd_chunk.py``.
"""
MATCH = r"ssd_step_(conv|state)_kernel"
HEAD_DIM, STATE, EXPAND, CONV = 64, 128, 2, 4
MAMBA_SHARE = (9, 10)


def launch_shapes(job, model):
    """A decode step: one launch a Mamba-2 layer over the rows it steps
    (the job's rows with a frame)."""
    if job.kind != "decode" or not job.decode_rows:
        return []
    h = EXPAND * model["d_model"] // HEAD_DIM
    layers = model["n_layers"] * MAMBA_SHARE[0] // MAMBA_SHARE[1]
    shape = dict(rows=len(job.decode_rows), H=h, P=HEAD_DIM, N=STATE,
                 C=h * HEAD_DIM + 2 * STATE, W=CONV)
    return [shape] * layers


def launch_cost(shape):
    r, h, p, n, c, w = (shape[k] for k in ("rows", "H", "P", "N", "C", "W"))
    e = shape.get("elem", 2)
    flops = 5 * r * h * p * n
    nbytes = (r * 2 * h * p * n * 4 + r * 2 * (w - 1) * c * 4
              + r * (c + h + h * p) * e + (w + 1) * c * e)
    return float(flops), float(nbytes)
