"""Operations and bytes of each hand-written kernel, from its shapes.

One module per kernel (``costs/<kernel>.py``) gives ``MATCH``, a regular
expression for the device kernel names its launches show in a profiler
trace, ``launch_shapes(job, model)``, the shapes of a served job's
launches of the kernel (one a layer; none where the job's kind does not
run it), and ``launch_cost(shape) -> (flops, bytes)`` for one logical
launch. A configuration names the kernels its model runs
(``serving.kernels``). Bytes count each input read once and each output written once;
where the work depends on the data (rows skipped, cache lengths) they
count what these inputs need. ``peaks`` holds the chip's published
peaks and ``model`` the model operations of a served step.
"""
