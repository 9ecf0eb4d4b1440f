"""Serving and training runtimes: ``ServeEngine``, the fault-tolerant ``train`` loop."""
