"""AdamW with an f32 master copy, and the learning-rate schedules."""
