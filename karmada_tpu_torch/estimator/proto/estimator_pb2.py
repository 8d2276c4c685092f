# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: estimator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x65stimator.proto\x12\x15karmada_tpu.estimator\"\x86\x01\n\nToleration\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x10\n\x08operator\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x04 \x01(\t\x12\x1a\n\x12toleration_seconds\x18\x05 \x01(\x03\x12\x1e\n\x16has_toleration_seconds\x18\x06 \x01(\x08\"\xc3\x01\n\tNodeClaim\x12I\n\rnode_selector\x18\x01 \x03(\x0b\x32\x32.karmada_tpu.estimator.NodeClaim.NodeSelectorEntry\x12\x36\n\x0btolerations\x18\x02 \x03(\x0b\x32!.karmada_tpu.estimator.Toleration\x1a\x33\n\x11NodeSelectorEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x8e\x02\n\x13ReplicaRequirements\x12\x34\n\nnode_claim\x18\x01 \x01(\x0b\x32 .karmada_tpu.estimator.NodeClaim\x12Y\n\x10resource_request\x18\x02 \x03(\x0b\x32?.karmada_tpu.estimator.ReplicaRequirements.ResourceRequestEntry\x12\x11\n\tnamespace\x18\x03 \x01(\t\x12\x1b\n\x13priority_class_name\x18\x04 \x01(\t\x1a\x36\n\x14ResourceRequestEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\"x\n\x1bMaxAvailableReplicasRequest\x12\x0f\n\x07\x63luster\x18\x01 \x01(\t\x12H\n\x14replica_requirements\x18\x02 \x01(\x0b\x32*.karmada_tpu.estimator.ReplicaRequirements\"4\n\x1cMaxAvailableReplicasResponse\x12\x14\n\x0cmax_replicas\x18\x01 \x01(\x05\"\x90\x01\n\x1cUnschedulableReplicasRequest\x12\x0f\n\x07\x63luster\x18\x01 \x01(\t\x12\x15\n\rresource_kind\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t\x12\x0c\n\x04name\x18\x04 \x01(\t\x12\'\n\x1funschedulable_threshold_seconds\x18\x05 \x01(\x03\"?\n\x1dUnschedulableReplicasResponse\x12\x1e\n\x16unschedulable_replicas\x18\x01 \x01(\x05\x32\x94\x02\n\tEstimator\x12\x7f\n\x14MaxAvailableReplicas\x12\x32.karmada_tpu.estimator.MaxAvailableReplicasRequest\x1a\x33.karmada_tpu.estimator.MaxAvailableReplicasResponse\x12\x85\x01\n\x18GetUnschedulableReplicas\x12\x33.karmada_tpu.estimator.UnschedulableReplicasRequest\x1a\x34.karmada_tpu.estimator.UnschedulableReplicasResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'estimator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODECLAIM_NODESELECTORENTRY._options = None
  _NODECLAIM_NODESELECTORENTRY._serialized_options = b'8\001'
  _REPLICAREQUIREMENTS_RESOURCEREQUESTENTRY._options = None
  _REPLICAREQUIREMENTS_RESOURCEREQUESTENTRY._serialized_options = b'8\001'
  _TOLERATION._serialized_start=43
  _TOLERATION._serialized_end=177
  _NODECLAIM._serialized_start=180
  _NODECLAIM._serialized_end=375
  _NODECLAIM_NODESELECTORENTRY._serialized_start=324
  _NODECLAIM_NODESELECTORENTRY._serialized_end=375
  _REPLICAREQUIREMENTS._serialized_start=378
  _REPLICAREQUIREMENTS._serialized_end=648
  _REPLICAREQUIREMENTS_RESOURCEREQUESTENTRY._serialized_start=594
  _REPLICAREQUIREMENTS_RESOURCEREQUESTENTRY._serialized_end=648
  _MAXAVAILABLEREPLICASREQUEST._serialized_start=650
  _MAXAVAILABLEREPLICASREQUEST._serialized_end=770
  _MAXAVAILABLEREPLICASRESPONSE._serialized_start=772
  _MAXAVAILABLEREPLICASRESPONSE._serialized_end=824
  _UNSCHEDULABLEREPLICASREQUEST._serialized_start=827
  _UNSCHEDULABLEREPLICASREQUEST._serialized_end=971
  _UNSCHEDULABLEREPLICASRESPONSE._serialized_start=973
  _UNSCHEDULABLEREPLICASRESPONSE._serialized_end=1036
  _ESTIMATOR._serialized_start=1039
  _ESTIMATOR._serialized_end=1315
# @@protoc_insertion_point(module_scope)
