"""Host input pipeline of the trainer: the train transform and the loader."""
