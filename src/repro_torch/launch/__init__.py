"""Launchers: the serve CLI (PyTorch port of `repro.launch.serve`)."""
