"""Distributed training helpers: the port of ``repro.distributed``."""

from repro_torch.distributed.compression import (
    compressed_psum_tree,
    compression_ratio,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = [
    "compressed_psum_tree", "compression_ratio", "dequantize_int8",
    "init_error_feedback", "quantize_int8",
]
