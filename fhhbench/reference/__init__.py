"""The plain reference: heavy hitters worked out again from the clients'
points and the configuration alone, in NumPy.  Nothing here imports
``torch``, ``jax``, either package of the program, or takes anything that
the program made."""
