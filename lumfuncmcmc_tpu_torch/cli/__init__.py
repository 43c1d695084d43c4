"""The port's command line: the ``fit`` subcommand."""
