"""columns_per_s: right-hand-side columns solved in the window over the
window's length (the window's start to the last call's end)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["columns"] / rec["window_s"]
