"""The benchmark of ``lqrrt_tpu_torch`` on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

    python -m portbench.run --workload boat.replan --seed 7 --seconds 30 \\
        --trace 0

Configurations live in ``portbench/configs/<name>.json``, traffic mixes in
``portbench/traffic/<name>.json``, one reader a metric in
``portbench/metrics/<metric>.py`` and one plain reference a model in
``portbench/reference/<model>.py``: the harness finds each by the name
``BENCHMARK.json`` gives, so a new cell is new files and a new entry.
"""
