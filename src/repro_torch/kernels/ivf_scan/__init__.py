from repro_torch.kernels.ivf_scan.ops import (ivf_scan, ivf_search,
                                              rerank_exact)

__all__ = ["ivf_scan", "ivf_search", "rerank_exact"]
