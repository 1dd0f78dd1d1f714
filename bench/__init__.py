"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell on the card and prints one JSON line.  Cells, configurations,
traffic mixes and metrics are files found by name: ``cells/<cell>.json``,
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the generator its
``kind`` names, ``traffic/<kind>.py``) and ``metrics/<metric>.py``.
"""
