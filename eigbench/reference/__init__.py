"""The plain references that decide whether a run is correct.

Plain NumPy, SciPy and PyTorch only: nothing here imports the measured
package, and every operator is rebuilt from its definition.
"""
