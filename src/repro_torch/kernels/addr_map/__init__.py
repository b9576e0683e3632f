"""K4: trace address decode (paper §5.2) with a per-bank histogram."""
