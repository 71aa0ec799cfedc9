"""The four model demos (port of the repo's demos/): plan, track, check and,
with ``--out``, draw.  Run as ``python -m lqrrt_tpu_torch.demos.<model>_demo``.
"""
