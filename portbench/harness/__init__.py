"""The harness of the port's benchmark: it finds a cell's files by name
(`spec`: the workload, the configuration, the traffic's generator, the
reference network, the metric readers), makes its inputs and weights from
the seed (`traffic`, `weights`), drives the port's timed path (`drivers`),
reads the trace and the program's spans in it (`tracing`,
`program_spans`), judges the outputs against the plain reference
(`check`) and prints the contract's result line (`cell`)."""
