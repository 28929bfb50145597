"""The port's benchmark: cells of (configuration, traffic mix) run on one card.

See README.md for the command, the cache directories and how to add a
configuration, a traffic mix, an operation or a metric as new files.
"""
