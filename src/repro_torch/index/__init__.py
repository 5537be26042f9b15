from repro_torch.index.flat import (FlatIndex, cosine_topk, l2_normalize,
                                    masked_cosine_topk, topk_scores)
from repro_torch.index.ivf import (IVF, IVFIndex, build_ivf,
                                   ivf_from_numpy, train_kmeans)
from repro_torch.index.segmented import SegmentedIndex

__all__ = ["cosine_topk", "topk_scores", "l2_normalize",
           "masked_cosine_topk", "FlatIndex",
           "IVF", "IVFIndex", "build_ivf", "ivf_from_numpy", "train_kmeans",
           "SegmentedIndex"]
