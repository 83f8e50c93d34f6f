"""Host-side helpers of the port: the config loader."""
