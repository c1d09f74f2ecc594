"""Analysis helpers of the port: the cost model's q-error report."""
