"""Dataset inputs: image files, the TextVQA reader and the progress manifest."""
