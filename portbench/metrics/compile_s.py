"""Host seconds to compile the cell's scenarios through the port (app,
fabric, routing matrix, route bank and ``compile_sim``), summed over them,
timed by the harness around the compile calls in set-up."""


def read(ctx):
    c = ctx["compile_s"]
    return sum(c) if c else None
