"""Launch utilities: the port's copy of `paddle_tpu/distributed/`'s
launcher (`launch.py`). Collectives and the multi-card data-parallel
paths are ROADMAP Queue 1 item 9.

`launch` is not imported here: `python -m
paddle_tpu_torch.distributed.launch` must execute it fresh under runpy.
"""
