from cerberusdet_tpu_torch.infer.inference import CerberusDetInference, build_category_map
from cerberusdet_tpu_torch.infer.preprocessor import CerberusPreprocessor

__all__ = ["CerberusDetInference", "CerberusPreprocessor", "build_category_map"]
