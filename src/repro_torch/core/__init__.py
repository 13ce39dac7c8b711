from repro_torch.core.codecs import (CODECS, Codec, DenseRefCodec,
                                     IdentityCodec, PackedBitstreamCodec,
                                     ThresholdGraphCodec, Wire,
                                     resolve_codec)
from repro_torch.core.compression import (compress_pytree, decompress_pytree,
                                          expected_pytree_wire_bytes,
                                          pytree_dense_bytes,
                                          pytree_wire_bytes, roundtrip_pytree,
                                          sparsify_quantize_dense)
from repro_torch.core.dynamic import (CompressionSchedule, greedy_search,
                                      make_schedule)
from repro_torch.core.server import ServerConfig, TeasqServer
from repro_torch.core.staleness import (aggregate_cache, merge_global,
                                        mixing_alpha,
                                        stacked_staleness_weights,
                                        staleness_weight, weighted_average)

__all__ = [
    "CODECS", "Codec", "DenseRefCodec", "IdentityCodec",
    "PackedBitstreamCodec", "ThresholdGraphCodec", "Wire", "resolve_codec",
    "compress_pytree", "decompress_pytree", "expected_pytree_wire_bytes",
    "pytree_dense_bytes", "pytree_wire_bytes", "roundtrip_pytree",
    "sparsify_quantize_dense",
    "CompressionSchedule", "greedy_search", "make_schedule",
    "ServerConfig", "TeasqServer",
    "aggregate_cache", "merge_global", "mixing_alpha",
    "stacked_staleness_weights", "staleness_weight", "weighted_average",
]
