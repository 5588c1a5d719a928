"""Distributed-systems layer of the port.

``planner``     — the bridge between the paper's scheduler and a training
                  step's collectives: translate a step's collective program
                  to a coflow Instance on the pod fabric, plan it with G-DM
                  on a live ``SchedulerSession`` (on the caller's device),
                  and translate the planned order back into gradient-bucket
                  launch order.  It mirrors ``repro.dist.planner``, with
                  ``extract_collectives`` (the reference's HLO parser) and
                  ``record_collectives`` (the same list read from a step
                  run on a DTensor mesh).
``compression`` — simulated gradient compression (quantise-dequantise),
                  shrinking the all-reduce payloads the planner schedules.
``partition``   — the parameter / batch partition rule table (plain specs)
                  and its DTensor placements on a mesh.
"""

__all__ = ["compression", "partition", "planner"]
