"""compile_s: the compile's own seconds (``Program.stats.compile_seconds``)
of the program set-up compiled, through ``api.compile`` or the service's
program cache."""


def read(rec):
    return rec.get("compile_s")
