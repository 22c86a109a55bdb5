"""One file a normalisation layer: ``apply``, found by the configuration's
``architecture.norm``."""
