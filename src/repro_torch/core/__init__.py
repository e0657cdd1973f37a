from repro_torch.core.decoder import (METHODS, DecodeConfig, DiffusionDecoder,
                                      GenerateResult)
from repro_torch.core.engine import Completion, Request, ServingEngine
from repro_torch.core.schedule import (confidence_and_tokens,
                                       dynamic_threshold, fixed_rate_select,
                                       select_tokens)
from repro_torch.core.suffix import (QueryRegion, steady_state_query_len,
                                     suffix_query_region)

__all__ = ["METHODS", "DecodeConfig", "DiffusionDecoder", "GenerateResult",
           "Completion", "Request", "ServingEngine",
           "confidence_and_tokens", "dynamic_threshold", "fixed_rate_select",
           "select_tokens", "QueryRegion", "steady_state_query_len",
           "suffix_query_region"]
