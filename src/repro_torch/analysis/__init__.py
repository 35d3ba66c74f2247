"""Dry-run analysis on the H100's data-sheet peaks: a step's cost from an
eager trace (``cost``), its collective bytes (``comm``), the roofline
terms (``roofline``) and the report tables (``report``). The
counterpart of ``repro.analysis``."""
