"""Training substrate: hand-rolled AdamW with its schedule, and the step
builders."""
