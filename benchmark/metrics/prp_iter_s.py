"""Test squarings (R0's, net of any Gerbicz-Li rollback) the PRP driver
completed over the window's seconds, a block cut where it stands. End to
end, host clock."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return ctx["net"] / ctx["window_s"]
