"""Distributed training support of the port: so far the single-process
fault tolerance (checkpoint/restart supervision, straggler watchdog)."""
