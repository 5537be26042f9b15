from repro_torch.kernels.fused_serve.ops import (FusedServe,
                                                 dyn_rerank_exact,
                                                 fused_serve,
                                                 fused_serve_probe,
                                                 pack_dyn_tiles)

__all__ = ["FusedServe", "dyn_rerank_exact", "fused_serve",
           "fused_serve_probe", "pack_dyn_tiles"]
