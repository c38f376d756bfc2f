"""Measurement tools of the port: ``gather_probe`` (row-fetch mechanisms)
and ``micro_floor`` (the tile kernel's empty shell)."""
