"""Host-side utilities: catalogs, artifact IO, logging, plots."""
