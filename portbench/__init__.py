"""The benchmark of ``repro_torch``, the engine's PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the cards of the
machine it is started on (see ``run.py``).  The yardstick lives here:
the data generator (``data/``), the plain references and the comparison
that decides ``correct`` (``reference/``), the H100's peaks and the byte
counts (``roofline.py``), the trace's reduction (``trace.py``), and one
file for each configuration, traffic mix, query and per-layer metric.
Nothing here imports JAX or the JAX package.
"""
