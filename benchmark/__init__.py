"""The benchmark of ``transformer_transducer_tpu_torch`` on one H100 (see
``benchmark/run.py``)."""
