"""Quantization (PyTorch counterpart of ``jvector_tpu.quantization``): PQ
(plain and anisotropic), SQ4, BQ, NVQ, and compressor files with their
cache."""

from jvector_tpu_torch.quantization.kmeans import kmeans, kmeans_pp_init
from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.bq import BinaryQuantization
from jvector_tpu_torch.quantization.nvq import NVQuantization, NVQVectors
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.quantization.serialize import CompressorCache, load_compressor, save_compressor

__all__ = [
    "kmeans",
    "kmeans_pp_init",
    "ProductQuantization",
    "BinaryQuantization",
    "NVQuantization",
    "NVQVectors",
    "ScalarQuantization4",
    "CompressorCache",
    "load_compressor",
    "save_compressor",
]
