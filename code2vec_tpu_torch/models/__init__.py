from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.models.hierarchical import HierarchicalAttentionPool

__all__ = ["Code2Vec", "Code2VecConfig", "HierarchicalAttentionPool"]
