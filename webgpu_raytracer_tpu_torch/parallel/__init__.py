"""The render farm: its wire protocol, coordinator and workers."""
