"""Data parallelism of the port (counterpart of point_teacher_tpu/parallel):
the collectives that make a world of ranks compute the global-batch step
(dist.py) and the launcher of a world of CPU ranks (launch.py)."""
