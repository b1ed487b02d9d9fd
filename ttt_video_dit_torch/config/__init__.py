"""Configuration: the job (TOML + flags) and the model presets."""
