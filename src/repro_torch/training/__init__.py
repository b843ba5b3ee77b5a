"""AdamW, learning-rate schedules and the train / distill step factories."""
