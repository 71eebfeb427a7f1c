from weaviate_tpu_torch.config.config import (
    AuthConfig,
    AuthzConfig,
    Config,
    ConfigError,
    ControllerConfig,
    IvfConfig,
    load_config,
)

__all__ = ["Config", "AuthConfig", "AuthzConfig", "ConfigError",
           "ControllerConfig", "IvfConfig", "load_config"]
