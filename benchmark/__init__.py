"""The port's benchmark: whole CLI jobs and resident-index queries of
``slamem_tpu_torch`` on one card. ``benchmark/run.py`` runs one cell of
``BENCHMARK.json``; ``README.md`` says how to run and extend it."""
