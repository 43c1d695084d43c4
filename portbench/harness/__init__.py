"""The benchmark's general code: cells found by name with the code their
files name, the counters and spans around the program's calls, the trace
reader and the arithmetic shared by the checks that decide ``correct``.
What belongs to one configuration or mix lives in ``systems/``,
``reference/``, ``catalogs/`` and ``drivers/``."""
