"""Utilities (PyTorch counterpart of ``jvector_tpu.util``): datasets and
their loaders, fvecs / ivecs / bvecs IO, dataset catalogs, the YAML reader,
memory accounting, the device rule and the native host-IO library."""
