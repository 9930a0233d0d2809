from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

__all__ = ["Code2Vec", "Code2VecConfig"]
