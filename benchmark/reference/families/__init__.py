"""One file a model family: ``forward`` (its plain train or eval pass from
a dict of weights by name) and ``macs`` (its conv and linear MACs an
image), found by the configuration's ``architecture.family``."""
