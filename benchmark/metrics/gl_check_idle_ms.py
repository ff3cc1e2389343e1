"""Device idle time in ms a complete Gerbicz-Li check (its span: from its
first replay squaring to the end of its get_int of R1), the mean over the
checks the traced window holds whole. Layer: the PRP driver
(modes/prp_ll.py) with the engine's get_int."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["checks"]:
        return None
    return 1e3 * sum(c["idle_s"] for c in tr["checks"]) / len(tr["checks"])
