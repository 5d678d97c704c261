from cerberusdet_tpu_torch.infer.inference import CerberusDetInference, build_category_map
from cerberusdet_tpu_torch.infer.preprocessor import CerberusPreprocessor
from cerberusdet_tpu_torch.infer.visualizer import CerberusVisualizer

__all__ = ["CerberusDetInference", "CerberusPreprocessor", "CerberusVisualizer",
           "build_category_map"]
