"""Launchers: the device mesh (``mesh``) and the QFT training launcher
(``train``)."""
