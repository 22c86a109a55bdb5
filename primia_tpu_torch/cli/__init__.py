"""Command-line entry points of the port: ``train``, ``inference``,
``evaluate``, ``find_config``, ``warm`` and the figure sweeps
``figure_sigma`` and ``figure_lambda``."""
