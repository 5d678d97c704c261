from cerberusdet_tpu_torch.serve.server import BatchingEngine, make_server

__all__ = ["BatchingEngine", "make_server"]
