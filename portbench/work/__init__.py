"""Work counts from a configuration's shapes, one file per counted thing.
They read only the configuration's "config" object (widths, point and
center counts, neighbours) and a batch size: never the port's graph, so
they count the same work whatever implements it."""
