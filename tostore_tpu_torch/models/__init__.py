"""Data models of the port: schemas, configs, results, expressions
(counterpart of `tostore_tpu/models/`, host Python carried as it is).
"""
