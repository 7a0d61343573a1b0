"""CUDA graphs the program captured over the run (its counter
`graphs.captures`). Set-up captures every program the cell's traffic
uses, so a count above set-up's is a capture repeated later."""

import program


def read(run):
    return program.counter("graphs.captures")
