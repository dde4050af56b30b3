from repro_torch.models.api import Model, build_model
from repro_torch.models.common import ModelConfig, RunConfig
