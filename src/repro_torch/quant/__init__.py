"""Quantized vector store: int8 and PQ codecs with their compressed
distances, the exact float32 rerank and its vector tiers (host, device)
— `repro/quant`'s counterpart."""
from repro_torch.quant.codecs import (
    Int8Index,
    Int8Prep,
    PQIndex,
    PQPrep,
    QuantGather,
    adc_int8,
    adc_pq,
    build_pq_lut,
    build_quant_index,
    codec_key,
    compressed_filtered_topk,
    decode_int8,
    decode_pq,
    encode_int8,
    encode_pq,
    index_nbytes,
    prep_int8,
    prepare_query,
    quant_dist,
    store_ratio,
    train_int8,
    train_pq,
)
from repro_torch.quant.rerank import (exact_rerank, exact_rerank_store,
                                      rerank_pool, score_pool)
from repro_torch.quant.tiering import (DeviceVectorStore, HostVectorStore,
                                       as_vector_store)

__all__ = [
    "Int8Index", "Int8Prep", "PQIndex", "PQPrep", "QuantGather", "adc_int8",
    "adc_pq", "build_pq_lut", "build_quant_index", "codec_key",
    "compressed_filtered_topk", "decode_int8", "decode_pq", "encode_int8",
    "encode_pq", "index_nbytes", "prep_int8", "prepare_query", "quant_dist",
    "store_ratio", "train_int8", "train_pq", "exact_rerank",
    "exact_rerank_store", "rerank_pool", "score_pool", "DeviceVectorStore",
    "HostVectorStore", "as_vector_store",
]
