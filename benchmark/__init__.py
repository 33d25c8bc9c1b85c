"""The benchmark of ``dnn_inference_engine_tpu_torch`` on the card.

Run one cell with ``python3 -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything is
found by name from ``BENCHMARK.json``: a configuration in
``configs/<config>.json``, a traffic mix in ``traffic/<mix>.json``, a
cell's limits in ``limits/<workload>.json``, a metric's reader in
``metrics/<metric>.py``, a task in ``tasks/<task>.py``, a configuration's
family (its weights, its plain reference under ``reference/``, its
operation count and where the program keeps its int8 codes) in
``families/<family>.py``.
"""
