"""The main program's command line (counterpart of :mod:`tpuflow.cli`)."""

from tpuflow_torch.cli.parser import build_parser, parse_args_to_options  # noqa: F401
