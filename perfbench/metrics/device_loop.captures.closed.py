"""Graphs the device loops captured in the window (`DeviceLoops.stats`):
0 when set-up warmed every shape, since a capture stalls a request."""


def read(ctx):
    return ctx["graphs_delta"]
