"""The harness of the port's benchmark: it finds a cell's files by name
(`spec`), makes its inputs and weights from the seed (`traffic`,
`weights`), drives the port's timed path (`drivers`), reads the trace
(`tracing`), judges the outputs against the plain reference (`check`) and
prints the contract's result line (`cell`)."""
