# Host-code copy of eradiate_tpu/test_tools/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Scene factories for tests and smoke runs."""
