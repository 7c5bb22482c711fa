# Host-code copy of eradiate_tpu/pipelines/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from .logic import postprocess_measure  # noqa: F401
