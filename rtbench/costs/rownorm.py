"""``rownorm``: the port's RMS and layer norms, one launch a norm.

Shape: ``rows``, ``d`` (the width normalised), ``elem``, ``gate`` (the
gated RMS form reads a gate beside x). Operations: 4 an element. Bytes:
x (and the gate) read once and y written once, the weights once.

Launches a step: two a block and the final norm over the rows the step
runs (a prefill's bucket x length, the head's norm over its last
positions; a decode step's arena rows), and, where the model runs
Mamba-2 (its configuration lists ``ssd_step``), the gated norm over its
inner width (2 d_model) in each of its Mamba-2 layers (9 in 10).
"""
MATCH = r"rownorm_kernel"


def launch_shapes(job, model):
    d, layers = model["d_model"], model["n_layers"]
    rows = job.bucket * job.length if job.kind == "prefill" else job.bucket
    last = job.bucket
    shapes = [dict(rows=rows, d=d)] * (2 * layers) + [dict(rows=last, d=d)]
    if "ssd_step" in model.get("kernels", ()):
        shapes += [dict(rows=rows, d=2 * d, gate=True)] * (layers * 9 // 10)
    return shapes


def launch_cost(shape):
    rows, d, e = shape["rows"], shape["d"], shape.get("elem", 2)
    reads = 2 if shape.get("gate") else 1
    return float(4 * rows * d), float(rows * d * e * (reads + 1) + d * e)
