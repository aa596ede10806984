"""kmer_tpu — a k-mer counting engine on JAX/XLA.

Built from scratch against the capability surface of the reference
`jaxonwang/k-mer-count` (see SURVEY.md), not as a port: bases are 2-bit
codes end-to-end, k-mers are multi-word uint32 keys, counting is
sort + segment-sum (or a dense 4^k histogram), and multi-chip scaling is
jax.sharding + shard_map collectives.
"""

from .config import KmerConfig
from .pipeline.count import count_codes, count_fasta, count_files
from .pipeline.parity import parity_dump, parity_md5, SAMPLE_FASTA_MD5
from .pipeline.sketch import (estimate_distinct_files,
                              estimate_distinct_multi_k)
from .pipeline.streaming import StreamingCounter, stream_count_fasta
from .pipeline.table import KmerTable

__version__ = "0.5.0"

__all__ = [
    "KmerConfig", "KmerTable",
    "count_fasta", "count_files", "count_codes",
    "estimate_distinct_files", "estimate_distinct_multi_k",
    "StreamingCounter", "stream_count_fasta",
    "parity_dump", "parity_md5", "SAMPLE_FASTA_MD5",
]
