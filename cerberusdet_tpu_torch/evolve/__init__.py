"""Hyperparameter evolution: the genetic evolver (yolov5_evolver.py) and
Ray Tune's searchers (ray_evolver.py), with their bookkeeping (loggers.py).
Counterpart of cerberusdet_tpu/evolve/."""
