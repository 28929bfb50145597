"""One module a request kind: prepare (the pool, from the seed), weight,
call, amounts (bytes in, bytes out), check (the numbers compared, each with
its limit) and control (the reference, one guarantee broken, in the
program's place). ``run.py`` finds a module by the traffic mix's
``operation``."""
