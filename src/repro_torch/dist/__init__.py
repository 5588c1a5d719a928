"""Distributed-systems layer of the port.

``planner``     — the bridge between the paper's scheduler and a training
                  step's collectives: translate a step's collective program
                  to a coflow Instance on the pod fabric, plan it with G-DM
                  on a live ``SchedulerSession`` (on the caller's device),
                  and translate the planned order back into gradient-bucket
                  launch order.  It mirrors ``repro.dist.planner`` but for
                  ``extract_collectives``, which parses XLA HLO text.
``compression`` — simulated gradient compression (quantise-dequantise),
                  shrinking the all-reduce payloads the planner schedules.
"""

__all__ = ["compression", "planner"]
