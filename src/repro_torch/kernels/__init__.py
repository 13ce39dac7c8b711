from repro_torch.kernels.bitpack import BitReader, pack_segments
from repro_torch.kernels.ops import (compress_roundtrip,
                                     compress_roundtrip_leaves,
                                     fused_wire_encode, ssd)

__all__ = ["BitReader", "pack_segments", "compress_roundtrip",
           "compress_roundtrip_leaves", "fused_wire_encode", "ssd"]
