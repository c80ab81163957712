"""Training: schedules, optimizers, the train step and the loop (port of
``repro/training``)."""
