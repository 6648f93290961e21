"""Host preprocessing of raw ZTF object directories (NumPy and the
standard library; no pandas): the readers the raw-alert serving path
needs."""
