"""The benchmark substrate of the port: the subject model and the
evaluation protocol that the paper's table and figure scripts start from."""
