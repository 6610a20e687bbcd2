"""Verbatim copies of the program's generators and cost model, frozen so
that a later change to the program cannot move the benchmark's yardstick."""
