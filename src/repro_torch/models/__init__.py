from repro_torch.models.config import (LayerSpec, ModelConfig, get_config,
                                       list_configs, register)
from repro_torch.models.model import (ModelOutput, apply_model, init_cache,
                                      init_params)

__all__ = ["ModelConfig", "LayerSpec", "get_config", "list_configs",
           "register", "ModelOutput", "apply_model", "init_cache",
           "init_params"]
