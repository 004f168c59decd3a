"""The work a stage has to do, counted from the cell's shapes the same way
whatever implements it."""
