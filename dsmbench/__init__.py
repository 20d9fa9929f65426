"""dsm_tpu_torch's benchmark harness (run.py) and its yardstick: the data
generators, the plain reference miner, the comparison, the metric readers
and the data files of its configurations, traffic mixes and cells."""
