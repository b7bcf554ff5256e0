"""program_cycles: emitted cycles of the compiled program (a count; the
kernels step through them one after another)."""


def read(rec):
    return rec.get("program_cycles")
