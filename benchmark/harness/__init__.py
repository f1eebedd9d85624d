"""What every cell shares: the cell's files found by name, the traffic's
draws, the drivers, the trace's reduction and the comparison."""
