"""The benchmark of the PyTorch and CUDA port (``adversarial_spec_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric is a file of its own, found by the
name ``BENCHMARK.json`` gives it: ``configs/<file>``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``.
"""
