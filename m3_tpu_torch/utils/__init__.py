"""Foundation helpers copied from the reference: time units, bit IO."""
